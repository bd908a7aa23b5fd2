"""Warning taxonomy (ref ``cheetah/utils/warnings.py:1-66``)."""


class PhysicsWarning(Warning):
    """Base category for warnings about questionable physics configurations."""


class UnknownElementWarning(PhysicsWarning):
    """An element type in an imported lattice is not understood and was
    replaced (usually by a drift of equal length)."""


class NotUnderstoodPropertyWarning(PhysicsWarning):
    """A property in an imported lattice file is not understood and ignored."""


class NoBeamPropertiesInLatticeWarning(PhysicsWarning):
    """An imported lattice file did not define beam properties."""


class DefaultParameterWarning(PhysicsWarning):
    """A default parameter value is being used where an explicit value was
    expected."""


class DirtyNameWarning(Warning):
    """An element name is not a valid Python identifier, so attribute-style
    access on a segment will not work for it."""


class VisualizationWarning(Warning):
    """Something non-fatal went wrong while visualising the lattice."""
