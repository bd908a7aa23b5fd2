"""API parity of the PyTorch port with cheetah_tpu, as a ratchet.

Every public top-level name of ``cheetah_tpu`` and every public member of
its classes must exist in ``cheetah_tpu_torch``, and every parameter of a
shared public method must be accepted by the port's method, except for the
documented idiom exclusions below and the names in ``NOT_YET_PORTED``.
``NOT_YET_PORTED`` may only shrink: an entry whose name the port has gained
fails :func:`test_not_yet_ported_lists_only_missing_names`, so a slice that
ports a name also removes it here. Each entry names its ROADMAP Queue 1
item. Members are looked up on instances, since the port sets its
configuration (``name``, ``tracking_method``, ...) in ``__init__`` where the
JAX package declares dataclass fields.
"""

import importlib.util
import inspect
import pkgutil

import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu.parallel as jax_parallel
import cheetah_tpu_torch as ctt
import cheetah_tpu_torch.parallel as port_parallel
from cheetah_tpu.utils import checkpoint as jax_checkpoint
from cheetah_tpu_torch.utils import checkpoint as port_checkpoint
from element_zoo import ELEMENT_CASES

CPU = "cpu"

#: Names whose role other machinery plays in the port; each documents its
#: counterpart.
IDIOM_EXCLUSIONS = {
    # jax.export's pytree registry: the port's elements are nn.Modules,
    # exported through torch's own machinery.
    "register_export_serialization",
    # Segment's plan-time flag that keeps a fused run fused when it is
    # traced again under jax.checkpoint: the port decides skippability on
    # the host (Cavity's voltage flag) and traces nothing.
    "Segment.assume_skippable",
}

#: Parameters whose role other machinery plays in the port.
PARAMETER_EXCLUSIONS = {
    # A jax PRNG key -> a torch.Generator (`generator=`), checked below.
    "key",
}

#: Public names of cheetah_tpu that the port does not have yet, each with
#: its ROADMAP Queue 1 item. This list may only shrink; since the tenth
#: slice it is empty.
NOT_YET_PORTED: dict[str, int] = {}

#: Names this slice ported; none may stand in NOT_YET_PORTED.
STRUCTURE_NAMES = [
    "Element.clone", "Element.split", "Element.merge", "Element.defining_tensors",
    "Element.sanitize_name", "Element.transfer_map", "Segment.element_index",
    "Segment.subcell", "Segment.flattened", "Segment.reversed", "Segment.partition_at",
    "Segment.clone", "Segment.split", "Segment.merge", "Segment.transfer_maps_merged",
    "Segment.without_inactive_markers", "Segment.without_inactive_zero_length_elements",
    "Segment.inactive_elements_as_drifts", "Segment.with_consecutive_elements_merged",
    "Segment.explain_plan", "Segment.track_checkpointed", "Superimposed.flattened",
    "ParticleBeam.uniform_3d_ellipsoid", "ParticleBeam.randomly_subsampled",
    "ParticleBeam.energies", "ParticleBeam.momenta",
]

SPECIAL_INSTANCES = {
    "Element": lambda: ctt.Element(),
    "CustomTransferMap": lambda: ctt.CustomTransferMap(torch.eye(7, dtype=torch.float64)),
    "Segment": lambda: ctt.Segment([ctt.Drift(0.1, device=CPU)]),
    "Superimposed": lambda: ctt.Superimposed(
        ctt.Drift(0.1, device=CPU), ctt.Marker(device=CPU)
    ),
    "SpaceChargeKick": lambda: ctt.SpaceChargeKick(0.1, device=CPU),
    "ParticleBeam": lambda: ctt.ParticleBeam.from_parameters(
        num_particles=64, generator=torch.Generator().manual_seed(0), device=CPU
    ),
    "ParameterBeam": lambda: ctt.ParameterBeam.from_parameters(device=CPU),
    "Species": lambda: ctt.Species("electron", device=CPU),
}


def _top_level_names() -> list[str]:
    """The public top-level names of cheetah_tpu, the same in every process:
    its public attributes that are not modules, its ``__all__`` and its
    subpackages and modules (an attribute only once something imports
    them)."""
    names = {
        name
        for name in dir(ct)
        if not name.startswith("_") and not inspect.ismodule(getattr(ct, name))
    }
    names |= set(ct.__all__)
    names |= {info.name for info in pkgutil.iter_modules(ct.__path__) if not info.name.startswith("_")}
    return sorted(names)


def _port_has(name: str) -> bool:
    return hasattr(ctt, name) or importlib.util.find_spec(f"cheetah_tpu_torch.{name}") is not None


def _public_classes() -> list[str]:
    return [
        name
        for name in dir(ct)
        if not name.startswith("_") and isinstance(getattr(ct, name), type)
    ]


def _port_instances(name: str) -> list:
    """Instances of the port's class ``name`` to look members up on: one per
    element-zoo spec, a built one for the others, none for an abstract or
    warning class (looked up on the class itself)."""
    if name in SPECIAL_INSTANCES:
        return [SPECIAL_INSTANCES[name]()]
    specs = [spec for class_name, spec, _ in ELEMENT_CASES if class_name == name and spec is not None]
    cls = getattr(ctt, name)
    return [
        cls(**spec, dtype=torch.float64, device=CPU)
        for spec in specs
    ]


def _missing_members(name: str) -> list[str]:
    """Public members of ``cheetah_tpu.<name>`` that the port's class and
    its instances lack. ``Beam``, abstract in both, is looked up on both of
    the port's beam classes."""
    jax_cls = getattr(ct, name)
    members = {member for member in dir(jax_cls) if not member.startswith("_")}
    if name == "Beam":
        holders = [[getattr(ctt, beam)] + _port_instances(beam)
                   for beam in ("ParticleBeam", "ParameterBeam")]
    else:
        holders = [[getattr(ctt, name)] + _port_instances(name)]
    return sorted(
        member
        for member in members
        if not all(any(hasattr(obj, member) for obj in group) for group in holders)
    )


def _not_ported_or_excluded(qualified: str) -> bool:
    return qualified in NOT_YET_PORTED or qualified in IDIOM_EXCLUSIONS


def _excused(name: str, member: str) -> bool:
    """A member excused on its class or, for an inherited member, on
    Element or Segment."""
    return any(
        _not_ported_or_excluded(f"{owner}.{member}")
        for owner in (name, "Element", "Segment")
        if owner == name or issubclass(getattr(ct, name), getattr(ct, owner))
    )


def test_top_level_names_all_present():
    missing = [
        name
        for name in _top_level_names()
        if not _port_has(name) and not _not_ported_or_excluded(name)
    ]
    assert missing == [], f"cheetah_tpu names without counterpart: {missing}"


@pytest.mark.parametrize("name", _public_classes())
def test_class_members_all_present(name):
    assert hasattr(ctt, name), name
    missing = [member for member in _missing_members(name) if not _excused(name, member)]
    assert missing == [], f"{name}: members without counterpart: {missing}"


def test_not_yet_ported_lists_only_missing_names():
    """The ratchet: an entry whose name the port now has must go."""
    stale = []
    for qualified in NOT_YET_PORTED:
        if "." not in qualified:
            if _port_has(qualified):
                stale.append(qualified)
            continue
        name, member = qualified.split(".")
        holders = [getattr(ctt, name)] + _port_instances(name)
        if any(hasattr(obj, member) for obj in holders):
            stale.append(qualified)
    assert stale == [], f"ported, so remove from NOT_YET_PORTED: {stale}"
    assert NOT_YET_PORTED == {}


def test_structure_operations_are_not_on_the_list():
    assert not set(STRUCTURE_NAMES) & set(NOT_YET_PORTED)
    for qualified in STRUCTURE_NAMES:
        name, member = qualified.split(".")
        assert hasattr(getattr(ctt, name), member), qualified


def _parameters(fn) -> dict | None:
    try:
        signature = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return {
        pname: parameter
        for pname, parameter in signature.parameters.items()
        if pname not in ("self", "cls")
        and parameter.kind not in (parameter.VAR_POSITIONAL, parameter.VAR_KEYWORD)
    }


def _accepts_any_keyword(fn) -> bool:
    try:
        parameters = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(parameter.kind is parameter.VAR_KEYWORD for parameter in parameters)


@pytest.mark.parametrize("name", _public_classes())
def test_shared_method_parameters_accepted(name):
    """Every parameter of a shared public method (constructors included) is
    a parameter of the port's method; a method that takes a jax ``key``
    takes a ``generator`` in the port. A parameter named like an excused
    member (``Segment.assume_skippable``) is excused with it."""
    jax_cls, port_cls = getattr(ct, name), getattr(ctt, name)
    problems = {}
    for member in ["__init__"] + [m for m in dir(jax_cls) if not m.startswith("_")]:
        jax_fn, port_fn = getattr(jax_cls, member, None), getattr(port_cls, member, None)
        if not callable(jax_fn) or not callable(port_fn) or isinstance(jax_fn, type):
            continue
        theirs, ours = _parameters(jax_fn), _parameters(port_fn)
        if theirs is None or ours is None or _accepts_any_keyword(port_fn):
            continue
        missing = [
            p
            for p in theirs
            if p not in ours and p not in PARAMETER_EXCLUSIONS and not _excused(name, p)
        ]
        if "key" in theirs and "generator" not in ours:
            missing.append("key -> generator")
        if missing:
            problems[member] = missing
    assert problems == {}, f"{name}: parameters without counterpart: {problems}"


def test_idiom_exclusions_name_real_jax_members():
    for qualified in [*IDIOM_EXCLUSIONS, *NOT_YET_PORTED]:
        if "." in qualified:
            name, member = qualified.split(".")
            assert hasattr(getattr(ct, name), member), qualified
        else:
            assert qualified in _top_level_names(), qualified


# ---------------------------------------------------------------------------
# The multi-device layer and the checkpoints (Queue 1 item 8)
# ---------------------------------------------------------------------------


def _module_functions(module) -> list[str]:
    return [
        name
        for name, value in vars(module).items()
        if inspect.isfunction(value) and value.__module__ == module.__name__
        and not name.startswith("_")
    ]


MODULE_NAMES = [
    *((jax_parallel, port_parallel, name) for name in jax_parallel.__all__),
    *((jax_checkpoint, port_checkpoint, name) for name in _module_functions(jax_checkpoint)),
]


@pytest.mark.parametrize(
    "jax_module, port_module, name", MODULE_NAMES,
    ids=[f"{jax_module.__name__}.{name}" for jax_module, _, name in MODULE_NAMES],
)
def test_multi_device_names_present(jax_module, port_module, name):
    """Every name of ``cheetah_tpu.parallel.__all__`` and every public
    function of ``cheetah_tpu.utils.checkpoint`` exists in the port, and a
    function's parameters are accepted by the port's."""
    assert hasattr(port_module, name), name
    theirs, ours = getattr(jax_module, name), getattr(port_module, name)
    if inspect.isfunction(theirs):
        missing = [p for p in _parameters(theirs) if p not in _parameters(ours)]
        assert missing == [], f"{name}: parameters without counterpart: {missing}"


def _multi_device_instance(name: str):
    if name == "BatchedLatticeEnv":
        segment = ctt.Segment([ctt.Drift(0.1, name="d", device=CPU)])
        beam = SPECIAL_INSTANCES["ParticleBeam"]()
        return port_parallel.BatchedLatticeEnv(segment, beam, [("d", "length")])
    return port_parallel.CollectiveReport([], ("hosts",))


@pytest.mark.parametrize("name", ["BatchedLatticeEnv", "CollectiveReport"])
def test_multi_device_class_members_and_parameters(name):
    """The members of the JAX classes (dataclass fields included) exist on
    the port's instances, and their methods' parameters are accepted."""
    jax_cls, port_cls = getattr(jax_parallel, name), getattr(port_parallel, name)
    members = {m for m in dir(jax_cls) if not m.startswith("_")}
    members |= {field for field in getattr(jax_cls, "__dataclass_fields__", {})}
    instance = _multi_device_instance(name)
    assert sorted(m for m in members if not hasattr(instance, m)) == []
    for member in ["__init__", *members]:
        theirs, ours = getattr(jax_cls, member, None), getattr(port_cls, member, None)
        if callable(theirs) and callable(ours) and _parameters(theirs) is not None:
            missing = [p for p in _parameters(theirs) if p not in _parameters(ours)]
            assert missing == [], f"{name}.{member}: parameters without counterpart: {missing}"


# ---------------------------------------------------------------------------
# The converters, plotting and the auxiliary utilities (Queue 1 item 9)
# ---------------------------------------------------------------------------

#: Names of ``cheetah_tpu.utils.__all__`` that are JAX pytree or PRNG
#: machinery, each with the port's counterpart.
UTILS_IDIOM_EXCLUSIONS = {
    # A jax PRNG key -> the `generator=` (a torch.Generator) of every
    # function that draws.
    "ensure_key": "generator",
    "next_key": "generator",
    "seed": "generator",
    # Pytree dataclass fields -> nn.Module buffers (physical parameters)
    # and plain attributes (configuration).
    "pytree_dataclass": "nn.Module",
    "static_field": "nn.Module",
    "axis_field": "nn.Module",
}

#: Parameters that the port names in torch's idiom: a jax PRNG key is a
#: torch.Generator, numpy's and jax's ``axis`` is torch's ``dim``.
PARAMETER_RENAMES = {"key": "generator", "axis": "dim"}

AUX_MODULES = [
    "converters", "converters.astra", "converters.bmad", "converters.elegant",
    "converters.expressions", "converters.lattice_files", "converters.nxtables",
    "converters.ocelot", "converters.openpmd", "plotting", "utils", "utils.aot",
    "utils.assets", "utils.plot", "utils.profiling", "utils.vector",
]


def _public_names(module) -> list[str]:
    """A package's ``__all__``, a module's public functions and classes."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [
        name
        for name, value in vars(module).items()
        if (inspect.isfunction(value) or inspect.isclass(value))
        and value.__module__ == module.__name__ and not name.startswith("_")
    ]


AUX_NAMES = [
    (module, name)
    for module in AUX_MODULES
    for name in _public_names(importlib.import_module(f"cheetah_tpu.{module}"))
    if not (module == "utils" and name in UTILS_IDIOM_EXCLUSIONS)
]


@pytest.mark.parametrize("module, name", AUX_NAMES, ids=[f"{m}.{n}" for m, n in AUX_NAMES])
def test_aux_names_present(module, name):
    """Every name of ``cheetah_tpu.converters.__all__`` and
    ``cheetah_tpu.utils.__all__`` (but the idiom exclusions), and every
    public function and class of the converter modules, ``plotting``,
    ``utils.aot``, ``utils.assets``, ``utils.plot``, ``utils.profiling`` and
    ``utils.vector`` exists in the port, and the port's function accepts
    every parameter of the JAX function (or its torch name,
    ``PARAMETER_RENAMES``)."""
    theirs = getattr(importlib.import_module(f"cheetah_tpu.{module}"), name)
    port_module = importlib.import_module(f"cheetah_tpu_torch.{module}")
    assert hasattr(port_module, name), f"cheetah_tpu_torch.{module}.{name}"
    ours = getattr(port_module, name)
    if inspect.isfunction(theirs):
        missing = [p for p in _parameters(theirs) if p not in _parameters(ours)
                   and PARAMETER_RENAMES.get(p) not in _parameters(ours)]
        assert missing == [], f"{module}.{name}: parameters without counterpart: {missing}"


def test_utils_idiom_exclusions_are_jax_machinery():
    """Each exclusion is a name of ``cheetah_tpu.utils.__all__`` that the
    port does not export."""
    import cheetah_tpu.utils as jax_utils
    import cheetah_tpu_torch.utils as port_utils

    for name in UTILS_IDIOM_EXCLUSIONS:
        assert name in jax_utils.__all__ and not hasattr(port_utils, name), name

