"""Utilities of the PyTorch port (counterpart of ``cheetah_tpu/utils``):
physics helpers, maths, statistics, names, warnings and devices.

The names the JAX package exports here, except its pytree and PRNG
machinery, which the port's idiom replaces: elements are ``nn.Module``s
(for ``pytree_dataclass``, ``static_field``, ``axis_field``) and random
draws take a ``torch.Generator`` (for ``ensure_key``, ``next_key``,
``seed``). ``replace`` and ``tree_equal`` work on the port's modules and
beams (:mod:`cheetah_tpu_torch.utils.tree`).
"""

from cheetah_tpu_torch.utils.elementwise_linspace import elementwise_linspace
from cheetah_tpu_torch.utils.maths import (
    cos_sqrt,
    cossqrtmcosdivdiff,
    log1pdiv,
    si1mdiv,
    si2msi2divdiff,
    sicos1mdiv,
    simsidivdiff,
    sinc_sqrt,
    sipsicos3mdiv,
    sqrta2minusbdiva,
)
from cheetah_tpu_torch.utils.names import UniqueNameGenerator, merge_element_names
from cheetah_tpu_torch.utils.physics import compute_relativistic_factors
from cheetah_tpu_torch.utils.statistics import (
    match_distribution_moments,
    unbiased_weighted_covariance,
    unbiased_weighted_covariance_matrix,
    unbiased_weighted_std,
    unbiased_weighted_variance,
)
from cheetah_tpu_torch.utils.tree import replace, tree_equal
from cheetah_tpu_torch.utils.warnings import (
    DefaultParameterWarning,
    DirtyNameWarning,
    NoBeamPropertiesInLatticeWarning,
    NotUnderstoodPropertyWarning,
    PhysicsWarning,
    UnknownElementWarning,
    VisualizationWarning,
)

__all__ = [
    "compute_relativistic_factors",
    "cos_sqrt",
    "cossqrtmcosdivdiff",
    "DefaultParameterWarning",
    "DirtyNameWarning",
    "elementwise_linspace",
    "log1pdiv",
    "match_distribution_moments",
    "merge_element_names",
    "NoBeamPropertiesInLatticeWarning",
    "NotUnderstoodPropertyWarning",
    "PhysicsWarning",
    "replace",
    "si1mdiv",
    "si2msi2divdiff",
    "sicos1mdiv",
    "simsidivdiff",
    "sinc_sqrt",
    "sipsicos3mdiv",
    "sqrta2minusbdiva",
    "tree_equal",
    "unbiased_weighted_covariance",
    "unbiased_weighted_covariance_matrix",
    "unbiased_weighted_std",
    "unbiased_weighted_variance",
    "UniqueNameGenerator",
    "UnknownElementWarning",
    "VisualizationWarning",
]
