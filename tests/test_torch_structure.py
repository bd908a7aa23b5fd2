"""The structure operations of the PyTorch port against cheetah_tpu on the
CPU, in float64: ``clone``, ``split``, ``merge``, ``__eq__``,
``defining_tensors``, ``sanitize_name``, ``transfer_map`` and ``is_active``
of the elements; ``element_index``, ``subcell``, ``flattened``,
``reversed``, ``partition_at``, ``clone``, ``split``, ``merge``, the lattice
passes and ``explain_plan`` of ``Segment``; and the new ``ParticleBeam``
methods.

Each operation runs on the same lattice in both packages: the ARES EA
subcell with its quadrupoles on, BASELINE config 3's chain, the ARES
stage-3 lattice in linear and in drift-kick-drift mode, and a line of
every element of ``tests/element_zoo.py`` with a nested segment and a
``Superimposed``. The results must have the same structure (types, names,
every defining feature; arrays within rtol 1e-12) and the same
``explain_plan`` text. The ARES EA subcell and config 3 after each
operation, stage 3 in linear mode after ``split``, ``transfer_maps_merged``
and ``with_consecutive_elements_merged``, and each zoo element split and
merged again track the same particles in both packages: within 1e-12 of
each coordinate's largest value where every element is linear, within 1e-9
(the nonlinear slices' tolerance) where drift-kick-drift or second-order
maps chain a few dozen operations per particle, and in stage 3, whose
seeded magnets grow the beam ~1000x (its own tests' tolerance). (The zoo line itself is not
tracked: its elements in a row send much of the beam out of the maps'
domains, non-finite in both packages.)
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from element_zoo import ELEMENT_CASES, build_jax_composite, build_jax_element
from test_torch_nonlinear import _chain
from cheetah_tpu_torch import interop
from test_torch_stage3 import jax_lattice
from test_torch_tracking import beam_to_torch

F64 = torch.float64
CPU = "cpu"
ARRAY_RTOL, ARRAY_ATOL = 1e-12, 1e-15
LINEAR_TOLERANCE, NONLINEAR_TOLERANCE = 1e-12, 1e-9
ENERGY = 1.5e8

ZOO_CASES = [
    (index, class_name, spec)
    for index, (class_name, spec, _) in enumerate(ELEMENT_CASES)
    if spec is not None
]


def _zoo_line():
    """Every zoo element but the screens, the cavities last: a transverse
    deflecting cavity behind them sends particles out of its map's domain
    (non-finite in both packages)."""
    cases = sorted(
        (case for case in ZOO_CASES if case[1] != "Screen"), key=lambda case: case[1] == "Cavity"
    )
    elements = [build_jax_element(class_name, spec) for _, class_name, spec in cases]
    elements.insert(5, build_jax_composite("Segment_nested"))
    elements.insert(9, build_jax_composite("Superimposed"))
    return ct.Segment(elements, name="zoo")


def _ares_ea():
    segment = jax_ares_ea_subcell(dtype=jnp.float64)
    segment.AREAMQZM1.k1 = jnp.asarray(4.0, jnp.float64)
    segment.AREAMQZM3.k1 = jnp.asarray(-6.0, jnp.float64)
    return segment


#: name: (function making the JAX lattice, whether every element is linear)
LATTICES = {
    "ares_ea": (_ares_ea, True),
    "config3": (_chain, False),
    "stage3_linear": (lambda: jax_lattice("linear"), True),
    "stage3_dkd": (lambda: jax_lattice("drift_kick_drift"), False),
    "zoo": (_zoo_line, False),
}


def _spec(element) -> dict:
    """A JAX element as :func:`interop.segment_from_numpy` takes it, with
    element-valued features (``Superimposed``'s two) and children described
    in turn."""
    spec = {"type": type(element).__name__}
    for feature in element.defining_features:
        value = getattr(element, feature)
        if feature == "elements":
            spec[feature] = [_spec(child) for child in value]
        elif isinstance(value, ct.Element):
            spec[feature] = _spec(value)
        elif isinstance(value, jax.Array):
            spec[feature] = np.asarray(value)
        else:
            spec[feature] = value
    return spec


def segment_to_torch(segment) -> ctt.Segment:
    return interop.segment_from_numpy(
        [_spec(element) for element in segment.elements], name=segment.name, device=CPU
    )


def _pick(segment, index):
    return segment.element_names[index]


#: name: operation on a segment of either package, returning a segment or
#: a tuple of elements. ``beam`` is that package's beam.
OPERATIONS = {
    "flattened": lambda s, beam: s.flattened(),
    "reversed": lambda s, beam: s.reversed(),
    "subcell": lambda s, beam: s.subcell(_pick(s, 2), _pick(s, -3)),
    "subcell_exclusive": lambda s, beam: s.subcell(
        _pick(s, 1), _pick(s, -2), include_start=False, include_end=False
    ),
    "subcell_to_end": lambda s, beam: s.subcell(start=_pick(s, 3)),
    "partition_before": lambda s, beam: s.partition_at(_pick(s, 3), mode="before"),
    "partition_after": lambda s, beam: s.partition_at(_pick(s, 3), mode="after"),
    "partition_both": lambda s, beam: s.partition_at(_pick(s, 3)),
    "split": lambda s, beam: type(s)(s.split(0.05), name="split"),
    "merged": lambda s, beam: s.with_consecutive_elements_merged(),
    "split_merged": lambda s, beam: type(s)(
        s.split(0.05), name="split"
    ).with_consecutive_elements_merged(),
    "merged_except": lambda s, beam: s.with_consecutive_elements_merged(
        except_for=[_pick(s, 2)]
    ),
    "without_markers": lambda s, beam: s.without_inactive_markers(),
    "without_zero_length": lambda s, beam: s.without_inactive_zero_length_elements(),
    "as_drifts": lambda s, beam: s.inactive_elements_as_drifts(except_for=[_pick(s, 0)]),
    "transfer_maps_merged": lambda s, beam: s.transfer_maps_merged(
        beam, except_for=[_pick(s, 4)]
    ),
    "merge": lambda s, beam: s.merge(s.subcell(end=_pick(s, 2))),
    "clone": lambda s, beam: s.clone(),
}
TRACKED = ("reversed", "split", "merged", "split_merged", "as_drifts", "without_zero_length",
           "transfer_maps_merged", "flattened")


def _value(value):
    if isinstance(value, (ct.Element, ctt.Element)):
        return describe(value)
    if isinstance(value, (list, tuple, torch.nn.ModuleList)) and any(
        isinstance(item, (ct.Element, ctt.Element)) for item in value
    ):
        return [describe(item) for item in value]
    if isinstance(value, torch.Tensor):
        return value.detach().numpy()
    if isinstance(value, jax.Array):
        return np.asarray(value)
    return value


def describe(element) -> dict:
    """Type, name and every defining feature of an element of either
    package, nested elements described in turn."""
    return {
        "type": type(element).__name__,
        **{feature: _value(getattr(element, feature)) for feature in element.defining_features},
    }


def assert_same_structure(port, expected, where="") -> None:
    if isinstance(expected, tuple):
        assert isinstance(port, tuple) and len(port) == len(expected)
        for index, (a, b) in enumerate(zip(port, expected)):
            assert_same_structure(a, b, f"{where}[{index}]")
        return
    _assert_same(describe(port), describe(expected), where)


def _assert_same(actual, expected, where) -> None:
    if isinstance(expected, dict):
        assert sorted(actual) == sorted(expected), where
        for key in expected:
            if key == "name" and "unnamed_element" in expected[key]:
                continue  # each package numbers its unnamed segments itself
            _assert_same(actual[key], expected[key], f"{where}.{key}")
    elif isinstance(expected, list):
        assert isinstance(actual, list) and len(actual) == len(expected), where
        for index, (a, b) in enumerate(zip(actual, expected)):
            _assert_same(a, b, f"{where}[{index}]")
    elif isinstance(expected, np.ndarray):
        np.testing.assert_allclose(actual, expected, rtol=ARRAY_RTOL, atol=ARRAY_ATOL,
                                   err_msg=where)
    else:
        assert actual == expected, (where, actual, expected)


def _particles(num_particles=300, seed=7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    phase_space = rng.normal(0.0, [1.7e-4, 4e-6, 1.7e-4, 4e-6, 1e-5, 1e-3],
                             size=(num_particles, 6))
    return np.concatenate([phase_space, np.ones((num_particles, 1))], axis=1)


def _beams():
    particles = _particles()
    jax_beam = ct.ParticleBeam(particles=jnp.asarray(particles), energy=jnp.asarray(ENERGY))
    return jax_beam, beam_to_torch(jax_beam)


def assert_tracks_alike(port_segment, jax_segment, linear: bool) -> None:
    jax_beam, beam = _beams()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # Eagerly: under jax.jit an idle cavity's voltage is a tracer, so the
        # JAX package would not fuse it as it does eagerly and as the port
        # does.
        expected = np.asarray(jax_segment.track(jax_beam).particles)
        got = port_segment.track(beam).particles.numpy()
    tolerance = LINEAR_TOLERANCE if linear else NONLINEAR_TOLERANCE
    scale = np.max(np.abs(expected), axis=tuple(range(expected.ndim - 1)))
    assert np.all(np.isfinite(expected))
    assert np.all(np.abs(got - expected) <= tolerance * scale)


@pytest.fixture(scope="module")
def lattices() -> dict:
    """Each lattice in both packages, built once: the port's from the JAX
    package's arrays."""
    built = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, (build, _) in LATTICES.items():
            jax_segment = build()
            built[name] = (jax_segment, segment_to_torch(jax_segment))
    return built


@pytest.mark.parametrize("lattice", list(LATTICES))
def test_explain_plan_matches_jax(lattice, lattices):
    jax_segment, segment = lattices[lattice]
    assert segment.explain_plan() == jax_segment.explain_plan()
    assert len(segment.explain_plan().splitlines()) == len(segment._plan())


@pytest.mark.parametrize("operation", list(OPERATIONS))
@pytest.mark.parametrize("lattice", list(LATTICES))
def test_structure_operation_matches_jax(lattice, operation, lattices):
    jax_segment, segment = lattices[lattice]
    jax_beam, beam = _beams()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = OPERATIONS[operation](jax_segment, jax_beam)
        got = OPERATIONS[operation](segment, beam)
    assert_same_structure(got, expected)
    if isinstance(expected, ct.Segment):
        assert got.explain_plan() == expected.explain_plan()
    # The operations leave the lattice they read as it was.
    assert_same_structure(segment, jax_segment)
    linear = LATTICES[lattice][1]
    if operation in TRACKED and lattice in ("ares_ea", "config3"):
        assert_tracks_alike(got, expected, linear)


@pytest.mark.parametrize("operation", ["split", "transfer_maps_merged", "merged"])
def test_stage3_linear_tracks_like_jax_after(operation, lattices):
    jax_segment, segment = lattices["stage3_linear"]
    jax_beam, beam = _beams()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = OPERATIONS[operation](jax_segment, jax_beam)
        got = OPERATIONS[operation](segment, beam)
    # With the seeded magnets the beam grows ~1000x through stage 3, and tau
    # gathers ~1e-9 of rounding between the packages in plain ``track``
    # already (``tests/test_torch_stage3.py``'s tolerance).
    assert_tracks_alike(got, expected, linear=False)


def test_beam_attrs_along_a_split_segment_match_jax(lattices):
    jax_segment, segment = lattices["ares_ea"]
    jax_beam, beam = _beams()
    expected = jax_segment.get_beam_attrs_along_segment(("s", "sigma_x"), jax_beam,
                                                        resolution=0.05)
    got = segment.get_beam_attrs_along_segment(("s", "sigma_x"), beam, resolution=0.05)
    for actual, wanted in zip(got, expected):
        assert actual.shape == wanted.shape
        np.testing.assert_allclose(actual.numpy(), np.asarray(wanted), rtol=1e-12)


def test_element_index_and_subcell_errors(lattices):
    jax_segment, segment = lattices["ares_ea"]
    name = jax_segment.element_names[4]
    assert segment.element_index(name) == jax_segment.element_index(name) == 4
    with pytest.raises(ValueError, match="not found"):
        segment.element_index("nothing")
    with pytest.raises(ValueError, match="not part"):
        segment.subcell(start="nothing")
    with pytest.raises(ValueError, match="not part"):
        segment.subcell(end="nothing")


# ---------------------------------------------------------------------------
# Elements of the zoo one by one
# ---------------------------------------------------------------------------


def _zoo_pair(class_name, spec):
    jax_element = build_jax_element(class_name, spec)
    return jax_element, segment_to_torch(ct.Segment([jax_element])).elements[0]


@pytest.mark.parametrize("index,class_name,spec", ZOO_CASES,
                         ids=[f"{c}-{i}" for i, c, _ in ZOO_CASES])
def test_split_and_remerge_match_jax(index, class_name, spec):
    jax_element, element = _zoo_pair(class_name, spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = ct.Segment(jax_element.split(jnp.asarray(0.1, jnp.float64)), name="s")
        got = ctt.Segment(element.split(0.1), name="s")
        assert_same_structure(got, expected)
        assert_same_structure(got.with_consecutive_elements_merged(),
                              expected.with_consecutive_elements_merged())
    assert len(got.elements) > 1 or class_name not in ("Drift", "Quadrupole", "Solenoid")
    linear = jax_element.tracking_method == "linear" and class_name != "Cavity"
    assert_tracks_alike(got, expected, linear)


@pytest.mark.parametrize("index,class_name,spec", ZOO_CASES,
                         ids=[f"{c}-{i}" for i, c, _ in ZOO_CASES])
def test_element_queries_match_jax(index, class_name, spec):
    """``is_active``, ``defining_tensors``, ``transfer_map`` (deprecated),
    ``__eq__`` against an equal and a changed copy."""
    jax_element, element = _zoo_pair(class_name, spec)
    if hasattr(jax_element, "is_active"):
        # The zoo gives a diagnostic's is_active as a number.
        assert bool(element.is_active) == bool(jax_element.is_active)
    assert element.defining_tensors == jax_element.defining_tensors
    if class_name != "Screen" and jax_element.tracking_method == "linear":
        energy = jnp.asarray(ENERGY, jnp.float64)
        with pytest.warns(DeprecationWarning):
            expected = jax_element.transfer_map(energy, ct.Species("electron", dtype=jnp.float64))
        with pytest.warns(DeprecationWarning):
            got = element.transfer_map(torch.tensor(ENERGY, dtype=F64),
                                       ctt.Species("electron", dtype=F64, device=CPU))
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-15)
    twin = _zoo_pair(class_name, spec)[1]
    assert element == twin and not element != twin
    tensors = element.defining_tensors
    if tensors:
        setattr(twin, tensors[0], getattr(twin, tensors[0]) + 1.0)
        jax_twin = build_jax_element(class_name, spec)
        setattr(jax_twin, tensors[0], getattr(jax_twin, tensors[0]) + 1.0)
        assert (element == twin) == (jax_element == jax_twin)
        assert not (element == twin)


@pytest.mark.parametrize("index,class_name,spec", ZOO_CASES,
                         ids=[f"{c}-{i}" for i, c, _ in ZOO_CASES])
def test_clone_is_equal_and_independent(index, class_name, spec):
    """The port's counterpart of ``tests/test_clone_equality.py:28-66``: an
    in-place edit of a clone's buffer, or of its metadata, never reaches
    the original; the clone keeps dtype and device."""
    _, element = _zoo_pair(class_name, spec)
    element.metadata = {"control_system": {"pv_base": "A:Q1:"}}
    clone = element.clone()
    assert clone == element and clone is not element and clone.name == element.name
    for name, buffer in element.named_buffers():
        twin = dict(clone.named_buffers())[name]
        assert twin.dtype == buffer.dtype and twin.device == buffer.device
        assert twin.data_ptr() != buffer.data_ptr()
    clone.metadata["control_system"]["pv_base"] = "B:Q2:"
    assert element.metadata["control_system"]["pv_base"] == "A:Q1:"
    tensors = element.defining_tensors
    if tensors:
        before = getattr(element, tensors[0]).clone()
        with torch.no_grad():
            getattr(clone, tensors[0]).add_(1.0)
        assert torch.equal(getattr(element, tensors[0]), before)
        assert clone != element


def test_clone_keeps_the_autograd_graph():
    k1 = torch.tensor(3.0, dtype=F64, requires_grad=True)
    quadrupole = ctt.Quadrupole(0.2, k1=k1, dtype=F64, device=CPU)
    (grad,) = torch.autograd.grad(quadrupole.clone().k1 * 2.0, k1)
    assert grad.item() == 2.0


def test_split_pieces_carry_the_length_gradient():
    """``split`` counts its pieces on the host; a gradient on the original
    length still reaches it through them."""
    length = torch.tensor(0.3, dtype=F64, requires_grad=True)
    pieces = ctt.Quadrupole(length, k1=4.0, dtype=F64, device=CPU).split(0.1)
    assert len(pieces) == 3
    (grad,) = torch.autograd.grad(ctt.Segment(pieces).length, length)
    assert grad.item() == pytest.approx(1.0, rel=1e-15)


def test_split_and_merge_keep_dtype():
    for dtype in (torch.float32, F64):
        quadrupole = ctt.Quadrupole(0.3, k1=4.0, dtype=dtype, device=CPU)
        merged = ctt.Segment(quadrupole.split(0.1)).with_consecutive_elements_merged()
        assert [e.length.dtype for e in quadrupole.split(0.1) + list(merged.elements)] == [
            dtype
        ] * 4


def test_merge_refuses_unlike_elements_as_jax_does():
    a = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
    pairs = [
        (ct.Drift(a(0.1)), ct.Drift(a(0.2), tracking_method="drift_kick_drift")),
        (ct.Quadrupole(a(0.1), k1=a(1.0), tilt=a(0.1)), ct.Quadrupole(a(0.1), k1=a(2.0))),
        (ct.Sextupole(a(0.1), k2=a(1.0)), ct.Sextupole(a(0.1), k2=a(2.0))),
        (ct.Solenoid(a(0.1), k=a(1.0), misalignment=a([1e-4, 0.0])), ct.Solenoid(a(0.1), k=a(1.0))),
        (ct.Dipole(a(0.1), angle=a(0.1)), ct.Dipole(a(0.1), angle=a(0.1))),
    ]
    for first, second in pairs:
        port_first, port_second = segment_to_torch(ct.Segment([first, second])).elements
        assert (port_first.merge(port_second) is None) == (first.merge(second) is None)
        assert port_first.merge(port_second) is None


# ---------------------------------------------------------------------------
# Equality, hashing and nn.Module
# ---------------------------------------------------------------------------


def _equality_pairs():
    a = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
    return {
        "same": (ct.Drift(a(0.1), name="d"), ct.Drift(a(0.1), name="d")),
        "other_name": (ct.Drift(a(0.1), name="a"), ct.Drift(a(0.1), name="b")),
        "other_length": (ct.Drift(a(0.1), name="d"), ct.Drift(a(0.2), name="d")),
        "other_type": (ct.Drift(a(0.0), name="d"), ct.Marker(name="d")),
        "other_method": (ct.Drift(a(0.1)), ct.Drift(a(0.1), tracking_method="second_order")),
        "other_shape": (ct.Quadrupole(a(0.1), k1=a(1.0)), ct.Quadrupole(a(0.1), k1=a([1.0]))),
        "segments": (
            ct.Segment([ct.Drift(a(0.1), name="d"), ct.Marker(name="m")], name="x"),
            ct.Segment([ct.Drift(a(0.1), name="d"), ct.Marker(name="m")], name="y"),
        ),
        "segment_child_names": (
            ct.Segment([ct.Drift(a(0.1), name="d")]), ct.Segment([ct.Drift(a(0.1), name="e")])
        ),
        "nested": (
            ct.Segment([ct.Segment([ct.Drift(a(0.1), name="d")], name="n")]),
            ct.Segment([ct.Segment([ct.Drift(a(0.2), name="d")], name="n")]),
        ),
        "superimposed": (
            ct.Superimposed(ct.Drift(a(0.2), name="b"), ct.Marker(name="m"), name="s"),
            ct.Superimposed(ct.Drift(a(0.2), name="b"), ct.Marker(name="m"), name="t"),
        ),
        "empty_segments": (ct.Segment([]), ct.Segment([])),
    }


@pytest.mark.parametrize("case", list(_equality_pairs()))
def test_equality_matches_jax(case):
    first, second = _equality_pairs()[case]
    port_first, port_second = segment_to_torch(ct.Segment([first, second])).elements
    assert (port_first == port_second) == (first == second)
    assert (port_first != port_second) == (first != second)
    assert port_first == port_first.clone()


def test_modules_keep_working_with_value_equality():
    """Two equal but distinct elements stay two modules: ``named_modules``,
    ``state_dict``, ``load_state_dict``, ``.to`` and sets of elements go by
    identity, as ``nn.Module`` needs."""
    kw = {"dtype": F64, "device": CPU}
    first, second = ctt.Drift(0.5, name="d", **kw), ctt.Drift(0.5, name="d", **kw)
    segment = ctt.Segment([first, second, ctt.Segment([ctt.Marker(**kw)])], name="line")
    assert first == second and hash(first) != hash(second)
    assert len({first, second}) == 2
    # The segment, its element list, three elements, the nested list, the marker.
    assert len(list(segment.named_modules())) == 7
    state = segment.state_dict()
    assert sorted(state) == ["elements.0.length", "elements.1.length", "elements.2.elements.0.length"]
    moved = segment.to("cpu", torch.float32)
    assert moved is segment and first.length.dtype == torch.float32
    clone = segment.clone()
    clone.load_state_dict({**state, "elements.1.length": torch.tensor(0.25)})
    assert clone.elements[1].length.item() == 0.25 and second.length.item() == 0.5
    assert clone != segment


def test_sanitize_name_and_helpers_match_jax():
    from cheetah_tpu.accelerator.element import validate_understood_kwargs as jax_validate
    from cheetah_tpu_torch.accelerator.element import (
        sum_element_lengths,
        validate_understood_kwargs,
    )

    jax_drift = ct.Drift(jnp.asarray(0.1, jnp.float64), name="AR.EA-01", sanitize_name=False)
    drift = ctt.Drift(0.1, name="AR.EA-01", sanitize_name=False, dtype=F64, device=CPU)
    jax_drift.sanitize_name()
    drift.sanitize_name()
    assert drift.name == jax_drift.name == "AR_EA_01"
    for validate in (jax_validate, validate_understood_kwargs):
        validate({"a": 1}, ["a", "b"])
        with pytest.raises(TypeError, match="'c'"):
            validate({"c": 1}, ["a"])
    lengths = [torch.tensor([0.1, 0.2], dtype=F64), torch.tensor(0.3, dtype=F64)]
    np.testing.assert_allclose(sum_element_lengths(lengths).numpy(), [0.4, 0.5], rtol=1e-15)
    assert sum_element_lengths([]).item() == 0.0


# ---------------------------------------------------------------------------
# ParticleBeam
# ---------------------------------------------------------------------------


def test_uniform_3d_ellipsoid_statistics():
    """Every point inside the ellipsoid, r^3 uniform, sigma_x = R / sqrt(5)
    within sampling error; the momenta Gaussian as asked. The random
    streams of the two packages differ, so statistics, not arrays, are
    compared."""
    num_particles, radii = 200_000, (1e-3, 2e-3, 5e-4)
    beam = ctt.ParticleBeam.uniform_3d_ellipsoid(
        num_particles=num_particles, radius_x=radii[0], radius_y=radii[1], radius_tau=radii[2],
        sigma_px=1e-4, sigma_py=2e-4, sigma_p=3e-4, energy=1e8, total_charge=1e-9,
        generator=torch.Generator().manual_seed(3), dtype=F64, device=CPU,
    )
    assert beam.particles.shape == (num_particles, 7) and len(beam) == num_particles
    scaled = [beam.x / radii[0], beam.y / radii[1], beam.tau / radii[2]]
    r3 = (scaled[0] ** 2 + scaled[1] ** 2 + scaled[2] ** 2) ** 1.5
    assert float(r3.max()) <= 1.0
    counts = torch.histc(r3, bins=10, min=0.0, max=1.0)
    expected = num_particles / 10
    assert float(torch.max(torch.abs(counts - expected))) < 5 * expected**0.5
    # The std of a sample std is sigma * sqrt((kurtosis - 1) / (4 N)); a
    # uniform ball's coordinate has kurtosis 15/7.
    relative = 5 * ((15 / 7 - 1) / (4 * num_particles)) ** 0.5
    for value, radius in zip((beam.sigma_x, beam.sigma_y, beam.sigma_tau), radii):
        assert value.item() == pytest.approx(radius / 5**0.5, rel=relative)
    for value, sigma in zip((beam.sigma_px, beam.sigma_py, beam.sigma_p), (1e-4, 2e-4, 3e-4)):
        assert value.item() == pytest.approx(sigma, rel=1e-12)
    assert beam.total_charge.item() == pytest.approx(1e-9, rel=1e-12)


def test_uniform_3d_ellipsoid_vectorised_like_jax():
    jax_beam = ct.ParticleBeam.uniform_3d_ellipsoid(
        num_particles=1000, radius_x=jnp.asarray([1e-3, 2e-3], jnp.float64),
        key=jax.random.PRNGKey(0), dtype=jnp.float64,
    )
    beam = ctt.ParticleBeam.uniform_3d_ellipsoid(
        num_particles=1000, radius_x=torch.tensor([1e-3, 2e-3], dtype=F64),
        generator=torch.Generator().manual_seed(0), device=CPU,
    )
    assert beam.particles.shape == jax_beam.particles.shape == (2, 1000, 7)
    assert beam.particles.dtype == F64
    assert torch.all(beam.particles[..., 6] == 1.0)
    ratio = (beam.sigma_x[1] / beam.sigma_x[0]).item()
    assert ratio == pytest.approx(float(jax_beam.sigma_x[1] / jax_beam.sigma_x[0]), rel=0.1)


def _vector_beams():
    rng = np.random.default_rng(11)
    particles = np.concatenate([rng.normal(0.0, 1e-4, (50, 6)), np.ones((50, 1))], axis=1)
    particles[:, 5] = rng.normal(0.0, 1e-3, 50)
    energy = np.array([1e8, 2e8, 5e8])
    charges = rng.uniform(1e-13, 2e-13, 50)
    jax_beam = ct.ParticleBeam(particles=jnp.asarray(particles), energy=jnp.asarray(energy),
                               particle_charges=jnp.asarray(charges))
    beam = ctt.ParticleBeam(torch.tensor(particles), torch.tensor(energy),
                            particle_charges=torch.tensor(charges))
    return jax_beam, beam


def test_energies_momenta_and_indexing_match_jax():
    jax_beam, beam = _vector_beams()
    for attribute in ("energies", "momenta"):
        np.testing.assert_allclose(getattr(beam, attribute).numpy(),
                                   np.asarray(getattr(jax_beam, attribute)), rtol=1e-14)
    for item in (1, slice(0, 2), (slice(None),)):
        expected, got = jax_beam[item], beam[item]
        for attribute in ("particles", "energy", "particle_charges", "survival_probabilities"):
            np.testing.assert_array_equal(getattr(got, attribute).numpy(),
                                          np.asarray(getattr(expected, attribute)))
    assert len(beam) == len(jax_beam) == 50


def test_randomly_subsampled():
    _, beam = _vector_beams()
    sub = beam.randomly_subsampled(20, generator=torch.Generator().manual_seed(1))
    assert sub.particles.shape == (20, 7) and len(sub) == 20
    rows = {tuple(row) for row in beam.particles.tolist()}
    assert all(tuple(row) in rows for row in sub.particles.tolist())
    assert sub.total_charge.item() == pytest.approx(beam.total_charge.item(), rel=1e-14)
    kept = beam.randomly_subsampled(20, adjust_particle_charges=False,
                                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(kept.particles, sub.particles)
    assert kept.total_charge.item() < beam.total_charge.item()
    with pytest.raises(ValueError, match="less than or equal"):
        beam.randomly_subsampled(51)

