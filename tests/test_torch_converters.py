"""The port's converters against cheetah_tpu's on the CPU, in float64.

Both packages read the same files and the same (duck-typed) Ocelot
objects: the expression evaluators and the lattice-file parser; the NX
Tables ARES linac, the Elegant FODO and cavity lattices, the Bmad tutorial
lattice and the reversed Elegant line; every case of
``tests/test_compare_ocelot.py`` and the duck-typed cell of
``tests/test_converters.py`` (with a copy of the ocelot shim of
``tests/test_full_ares.py``, which skips itself where the torch reference is
not mounted); ASTRA, Elegant SDDS and Ocelot beams.
Imported lattices must have the same element types, names and parameters
(read out of each package into numpy, equal to the last bit) and track the
same particles, drawn with numpy, within rtol 1e-10; beams from files
agree within 1e-12. The JAX package tracks eagerly: under ``jax.jit`` XLA
fuses the cavities' maps into other roundings, and the NX Tables linac's
tau moves 2.4e-8 of its largest value between its own jitted and eager runs,
where the port and the eager run agree to 2e-16. The port's
converters build on the GPU unless asked for the CPU, and raise without a
card.
"""

import importlib.util
import pathlib
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu.converters.expressions import evaluate_infix, evaluate_rpn
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.converters import expressions

RESOURCES = pathlib.Path(__file__).parent / "resources"
CPU = "cpu"
F64 = torch.float64
RTOL = 1e-10

LATTICES = {
    "nx_tables": (
        lambda: ct.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt"),
        lambda: ctt.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt", dtype=F64, device=CPU),
    ),
    "fodo": (
        lambda: ct.Segment.from_elegant(RESOURCES / "fodo.lte", "fodo", sanitize_names=True,
                                        dtype=jnp.float64),
        lambda: ctt.Segment.from_elegant(RESOURCES / "fodo.lte", "fodo", sanitize_names=True,
                                         dtype=F64, device=CPU),
    ),
    "reversed_fodo": (
        lambda: ct.Segment.from_elegant(RESOURCES / "fodo.lte", "reversed_fodo",
                                        sanitize_names=True, dtype=jnp.float64),
        lambda: ctt.Segment.from_elegant(RESOURCES / "fodo.lte", "reversed_fodo",
                                         sanitize_names=True, dtype=F64, device=CPU),
    ),
    "cavity": (
        lambda: ct.Segment.from_elegant(RESOURCES / "cavity.lte", "cavity", sanitize_names=True,
                                        dtype=jnp.float64),
        lambda: ctt.Segment.from_elegant(RESOURCES / "cavity.lte", "cavity",
                                         sanitize_names=True, dtype=F64, device=CPU),
    ),
    "bmad_tutorial": (
        lambda: ct.Segment.from_bmad(RESOURCES / "bmad_tutorial_lattice.bmad", dtype=jnp.float64),
        lambda: ctt.Segment.from_bmad(RESOURCES / "bmad_tutorial_lattice.bmad", dtype=F64,
                                      device=CPU),
    ),
}


def _quiet(build):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build()


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, jax.Array):
        return np.asarray(value)
    return value


def assert_same_elements(jax_element, port_element, path="") -> None:
    """The same type and name, and every defining feature of the JAX
    element equal in the port's, nested segments element by element."""
    label = f"{path}/{jax_element.name}"
    assert type(port_element).__name__ == type(jax_element).__name__, label
    assert port_element.name == jax_element.name, label
    for feature in jax_element.defining_features:
        ours, theirs = getattr(port_element, feature), getattr(jax_element, feature)
        if feature == "elements":
            assert len(ours) == len(theirs), label
            for their_child, our_child in zip(theirs, ours):
                assert_same_elements(their_child, our_child, label)
        elif isinstance(theirs, (ct.Element, ctt.Element)):
            assert_same_elements(theirs, ours, label)
        elif isinstance(theirs, jax.Array) or isinstance(ours, torch.Tensor):
            np.testing.assert_array_equal(_host(ours), _host(theirs), err_msg=f"{label}.{feature}")
        else:
            assert ours == theirs, f"{label}.{feature}: {ours!r} != {theirs!r}"


def numpy_beam(seed, num_particles=500, energy=1.07e8):
    rng = np.random.default_rng(seed)
    sigmas = np.array([1.7e-4, 2e-5, 1.7e-4, 2e-5, 1e-5, 1e-3])
    particles = np.concatenate(
        [rng.normal(size=(num_particles, 6)) * sigmas, np.ones((num_particles, 1))], axis=-1
    )
    return {
        "particles": particles,
        "energy": np.asarray(energy),
        "particle_charges": np.full(num_particles, 1e-10 / num_particles),
        "survival_probabilities": np.ones(num_particles),
    }


def jax_beam(arrays):
    return ct.ParticleBeam(**{key: jnp.asarray(value) for key, value in arrays.items()})


def port_beam(arrays, device=CPU):
    return interop.particle_beam_from_numpy(
        arrays["particles"], arrays["energy"], arrays["particle_charges"],
        arrays["survival_probabilities"], device=device,
    )


def assert_tracks_alike(jax_segment, port_segment, arrays) -> None:
    want = jax_segment.track(jax_beam(arrays))
    got = port_segment.track(port_beam(arrays))
    np.testing.assert_allclose(_host(got.particles), np.asarray(want.particles), rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(_host(got.energy), np.asarray(want.energy), rtol=RTOL)
    np.testing.assert_allclose(_host(got.survival_probabilities),
                               np.asarray(want.survival_probabilities), rtol=RTOL)


# ----------------------------------------------------------------------
# Expression evaluators
# ----------------------------------------------------------------------

INFIX = ["1 + 2 * 3", "(1 + 2) * 3", "2 ^ 3 ^ 1", "-5 + 3", "sqrt(16)", "2 * sin(0)",
         "0.5 * (0.3 + 0.7)", "0.6  -0.1", "1 / 4", "a * 3", "-b[l]", "sqrt(a) ^ 2 - b[l]"]
RPN = ["1 2 +", "2 3 4 + *", "9 sqrt", "1 2 + # some comment", "a 3 *", "b[l] a -"]
CONTEXT = {"a": 2.0, "b": {"l": 0.1}}


@pytest.mark.parametrize("expression", INFIX)
def test_infix_matches_jax(expression):
    assert expressions.evaluate_infix(expression, CONTEXT) == evaluate_infix(expression, CONTEXT)


@pytest.mark.parametrize("expression", RPN)
def test_rpn_matches_jax(expression):
    assert expressions.evaluate_rpn(expression, CONTEXT) == evaluate_rpn(expression, CONTEXT)


@pytest.mark.parametrize(
    "evaluate, expression",
    [("infix", "1 + unknown_thing"), ("infix", "(1 + 2"), ("rpn", "1 +"), ("rpn", "1 2")],
)
def test_invalid_expressions_raise_in_both(evaluate, expression):
    for module in (expressions, ct.converters.expressions):
        with pytest.raises(SyntaxError):
            getattr(module, f"evaluate_{evaluate}")(expression)


# ----------------------------------------------------------------------
# Lattice files
# ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(LATTICES))
def lattices(request):
    build_jax, build_port = LATTICES[request.param]
    return request.param, _quiet(build_jax), _quiet(build_port)


def test_imported_lattice_elements_match_jax(lattices):
    _, jax_segment, port_segment = lattices
    assert_same_elements(jax_segment, port_segment)


def test_imported_lattice_tracks_as_jax(lattices):
    name, jax_segment, port_segment = lattices
    assert_tracks_alike(jax_segment, port_segment, numpy_beam(len(name)))


def test_nx_tables_ares_shape():
    """The ARES linac of the NX Tables export: 226 elements over 44.22 m
    (the length the JAX package's import has), each class as the
    converter's table says."""
    segment = ctt.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt", dtype=F64, device=CPU)
    counts = {}
    for element in segment.elements:
        counts[type(element).__name__] = counts.get(type(element).__name__, 0) + 1
    assert len(segment.elements) == 226
    assert counts == {
        "Drift": 102, "Marker": 39, "HorizontalCorrector": 17, "VerticalCorrector": 16,
        "Screen": 15, "Quadrupole": 15, "BPM": 8, "Dipole": 6, "Cavity": 4, "Aperture": 3,
        "Undulator": 1,
    }
    np.testing.assert_allclose(float(segment.length.sum()), 44.2215, atol=1e-4)
    jax_length = ct.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt").length
    assert float(segment.length.sum()) == float(jnp.sum(jax_length))
    assert all(element.length.device.type == "cpu" for element in segment.elements)


def test_imported_ares_round_trips_lattice_json(tmp_path):
    """The imported ARES linac through LatticeJSON and back tracks to the
    same particles, bit for bit."""
    segment = ctt.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt", dtype=F64, device=CPU)
    segment.to_lattice_json(str(tmp_path / "ares.json"))
    restored = ctt.Segment.from_lattice_json(str(tmp_path / "ares.json"), dtype=F64, device=CPU)
    beam = port_beam(numpy_beam(3))
    assert torch.equal(restored.track(beam).particles, segment.track(beam).particles)


def test_elegant_reversed_line_is_the_reversed_forward_line():
    forward = _quiet(LATTICES["fodo"][1])
    reversed_import = _quiet(LATTICES["reversed_fodo"][1]).flattened()
    assert [e.name for e in reversed_import.elements] == [
        e.name for e in forward.reversed().elements
    ]


def test_cavity_lattice_values():
    segment = _quiet(LATTICES["cavity"][1])
    assert isinstance(segment.elements[0], ctt.CustomTransferMap)
    assert float(segment.elements[1].voltage) == 16175000.0
    assert float(segment.elements[1].phase) == 0.0  # 90 - 90


# ----------------------------------------------------------------------
# Ocelot
# ----------------------------------------------------------------------


def _install_ocelot_shim():
    """The ocelot stand-in of ``tests/test_full_ares.py``: element classes
    holding their constructor kwargs, with real ocelot's defaults."""
    if "ocelot" in sys.modules:
        return sys.modules["ocelot"]

    class OcelotElement:
        l = 0.0  # noqa: E741
        angle = k1 = k2 = k = e1 = e2 = tilt = fint = fintx = gap = 0.0
        v = freq = phi = lperiod = Kx = Ky = 0.0
        xmax = ymax = float("inf")
        type = "rect"

        def __init__(self, eid=None, **kwargs):
            self.id = eid
            for key, value in kwargs.items():
                setattr(self, key, value)

    module = types.ModuleType("ocelot")
    bend = type("Bend", (OcelotElement,), {})
    module.Bend = bend
    module.SBend = type("SBend", (bend,), {})
    module.RBend = type("RBend", (bend,), {})
    for name in ["Drift", "Quadrupole", "Sextupole", "Solenoid", "Hcor", "Vcor", "Cavity",
                 "TWCavity", "TDCavity", "Monitor", "Marker", "Undulator", "Aperture"]:
        setattr(module, name, type(name, (OcelotElement,), {}))
    sys.modules["ocelot"] = module
    return module


def _load_ares_cell():
    """The ARES stage-3 Ocelot cell of ``tests/resources``."""
    _install_ocelot_shim()
    spec = importlib.util.spec_from_file_location(
        "ares_stage3", RESOURCES / "ARESlatticeStage3v1_9.py"
    )
    ares = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ares)
    return ares.cell


def _ocelot_cases():
    ocelot = _install_ocelot_shim()

    class Undefined(ocelot.Drift.__mro__[1]):  # bare OcelotElement subclass
        pass

    return {
        "drift": ocelot.Drift(eid="d1", l=1.1),
        "quadrupole": ocelot.Quadrupole(eid="q1", l=0.31, k1=4.2),
        "sextupole": ocelot.Sextupole(eid="s1", l=0.21, k2=60.0),
        "solenoid": ocelot.Solenoid(eid="so1", l=0.4, k=2.5),
        "hcor": ocelot.Hcor(eid="hc1", l=0.05, angle=1.3e-4),
        "vcor": ocelot.Vcor(eid="vc1", l=0.05, angle=-2.1e-4),
        "sbend": ocelot.SBend(eid="b1", l=0.5, angle=0.08, e1=0.01, e2=0.015, tilt=0.05,
                              fint=0.1, fintx=0.2, gap=0.02),
        "rbend": ocelot.RBend(eid="rb1", l=0.5, angle=0.06, e1=0.04, e2=0.05, tilt=0.0,
                              fint=0.0, fintx=0.0, gap=0.0),
        "bend": ocelot.Bend(eid="be1", l=0.45, angle=-0.03, e1=0.0, e2=0.0, tilt=0.0,
                            fint=0.0, fintx=0.0, gap=0.0),
        "cavity": ocelot.Cavity(eid="c1", l=1.0377, v=0.01815975, freq=1.3e9, phi=0.0),
        "twcavity": ocelot.TWCavity(eid="tw1", l=1.0, v=0.005, freq=3e9, phi=10.0),
        "tdcavity": ocelot.TDCavity(eid="td1", l=0.7, v=0.002, freq=2.9e9, phi=5.0),
        "monitor_bsc": ocelot.Monitor(eid="AREABSCR1", l=0.0),
        "monitor_bpm": ocelot.Monitor(eid="AREABPMG1", l=0.0),
        "monitor_other": ocelot.Monitor(eid="monitor1", l=0.0),
        "marker": ocelot.Marker(eid="m1"),
        "undulator": ocelot.Undulator(eid="u1", l=2.0, lperiod=0.05, Kx=1.2, Ky=0.0),
        "aperture_rect": ocelot.Aperture(eid="ap1", xmax=2e-4, ymax=3e-4, type="rect"),
        "aperture_elip": ocelot.Aperture(eid="ap2", xmax=2e-4, ymax=3e-4, type="elip"),
        "unknown": Undefined(eid="weird1", l=0.25),
    }


OCELOT_CASES = _ocelot_cases()


@pytest.mark.parametrize("case_name", OCELOT_CASES)
def test_ocelot_element_matches_jax(case_name):
    element = OCELOT_CASES[case_name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = ct.converters.ocelot.convert_element(element, dtype=jnp.float64)
        ours = ctt.converters.ocelot.convert_element(element, dtype=F64, device=CPU)
    assert_same_elements(theirs, ours)
    jax_segment, port_segment = ct.Segment([theirs]), ctt.Segment([ours])
    assert_tracks_alike(jax_segment, port_segment, numpy_beam(7, energy=1.54e8))


def test_ocelot_warnings_and_defaults():
    with pytest.warns(ctt.DefaultParameterWarning):
        screen = ctt.converters.ocelot.convert_element(OCELOT_CASES["monitor_bsc"], device=CPU)
    assert screen.resolution == (2448, 2040)
    with pytest.warns(ctt.UnknownElementWarning, match="weird1"):
        converted = ctt.converters.ocelot.convert_element(OCELOT_CASES["unknown"], device=CPU)
    assert isinstance(converted, ctt.Drift)
    tdcavity = ctt.converters.ocelot.convert_element(OCELOT_CASES["tdcavity"], device=CPU)
    assert tdcavity.cavity_type == "standing_wave"


def test_ocelot_full_cell_matches_jax():
    cases = OCELOT_CASES
    cell = [cases[name] for name in ("drift", "quadrupole", "hcor", "sbend", "monitor_bpm",
                                     "sextupole", "vcor", "aperture_rect", "drift")]
    theirs = _quiet(lambda: ct.Segment.from_ocelot(cell, name="cmp", dtype=jnp.float64))
    ours = _quiet(lambda: ctt.Segment.from_ocelot(cell, name="cmp", dtype=F64, device=CPU))
    assert_same_elements(theirs, ours)
    assert_tracks_alike(theirs, ours, numpy_beam(8, energy=1.54e8))


def test_ocelot_duck_typed_cell_matches_jax():
    """The fake classes of ``tests/test_converters.py``: dispatch on class
    names alone."""

    def fake(name, **kwargs):
        return type(name, (), {})() if not kwargs else _with(type(name, (), {})(), kwargs)

    def _with(obj, kwargs):
        for key, value in kwargs.items():
            setattr(obj, key, value)
        return obj

    cell = [
        fake("Drift", id="d1", l=1.0),
        fake("Quadrupole", id="q1", l=0.3, k1=4.2),
        fake("Cavity", id="c1", l=1.0, v=0.005, freq=1.3e9, phi=0.0),
        fake("Monitor", id="BSC_screen", l=0.0),
        fake("Marker", id="m1"),
        fake("Aperture", id="ap1", xmax=1e-3, ymax=1e-3, type="rect"),
        fake("Unknown", id="u1", l=0.25),
    ]
    theirs = _quiet(lambda: ct.Segment.from_ocelot(cell, name="t", sanitize_names=True))
    ours = _quiet(lambda: ctt.Segment.from_ocelot(cell, name="t", sanitize_names=True,
                                                  dtype=F64, device=CPU))
    assert_same_elements(theirs, ours)


def test_subcell_of_ocelot_matches_jax():
    ocelot = _install_ocelot_shim()
    cell = [ocelot.Drift(eid="d1", l=0.5), ocelot.Marker(eid="start"),
            ocelot.Quadrupole(eid="q1", l=0.3, k1=2.0), ocelot.Marker(eid="stop"),
            ocelot.Drift(eid="d3", l=0.6)]
    ours = ctt.converters.ocelot.subcell_of_ocelot(cell, "start", "stop")
    theirs = ct.converters.ocelot.subcell_of_ocelot(cell, "start", "stop")
    assert [e.id for e in ours] == [e.id for e in theirs] == ["start", "q1", "stop"]


def test_ares_ocelot_cell_matches_jax():
    """The ARES stage-3 cell of ``tests/test_full_ares.py`` through both
    Ocelot converters."""
    cell = _load_ares_cell()
    theirs = _quiet(lambda: ct.Segment.from_ocelot(cell, name="ares", dtype=jnp.float64))
    ours = _quiet(lambda: ctt.Segment.from_ocelot(cell, name="ares", dtype=F64, device=CPU))
    assert_same_elements(theirs, ours)


class _ParticleArray:
    """Duck-typed Ocelot ``ParticleArray``: ``rparticles`` (6, N), ``E`` in
    GeV, ``q_array`` in C."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.rparticles = rng.normal(size=(6, 400)) * np.array([[1e-4], [1e-5], [2e-4],
                                                                [1e-5], [1e-5], [1e-3]])
        self.E = 0.107
        self.q_array = np.full(400, 2.5e-13)


def test_ocelot_beams_match_jax():
    parray = _ParticleArray(11)
    ours = ctt.ParticleBeam.from_ocelot(parray, dtype=F64, device=CPU)
    theirs = ct.ParticleBeam.from_ocelot(parray, dtype=jnp.float64)
    for field in ("particles", "energy", "particle_charges"):
        np.testing.assert_array_equal(_host(getattr(ours, field)), np.asarray(getattr(theirs, field)))
    ours = ctt.ParameterBeam.from_ocelot(parray, dtype=F64, device=CPU)
    theirs = ct.ParameterBeam.from_ocelot(parray, dtype=jnp.float64)
    for field in ("mu", "cov", "energy", "total_charge"):
        np.testing.assert_allclose(_host(getattr(ours, field)), np.asarray(getattr(theirs, field)),
                                   rtol=1e-12, atol=0)


# ----------------------------------------------------------------------
# Beam files
# ----------------------------------------------------------------------


def _write_astra_file(path, num_particles=50):
    """The synthetic ASTRA file of ``tests/test_converters.py``."""
    rng = np.random.default_rng(42)
    data = np.zeros((num_particles, 10))
    data[:, 0] = rng.normal(0, 1e-4, num_particles)
    data[:, 1] = rng.normal(0, 1e-4, num_particles)
    data[:, 2] = rng.normal(0, 1e-5, num_particles)
    data[0, 2] = 1.0
    data[:, 3] = rng.normal(0, 500.0, num_particles)
    data[:, 4] = rng.normal(0, 500.0, num_particles)
    data[:, 5] = rng.normal(0, 1e4, num_particles)
    data[0, 5] = 1.2e8
    data[:, 7] = -1.6e-10
    data[:, 9] = 1
    data[5, 9] = -1
    np.savetxt(path, data)


def test_astra_beams_match_jax(tmp_path):
    path = tmp_path / "synthetic.astra"
    _write_astra_file(path)
    ours = ctt.ParticleBeam.from_astra(str(path), dtype=F64, device=CPU)
    theirs = ct.ParticleBeam.from_astra(str(path), dtype=jnp.float64)
    assert ours.num_particles == 49
    for field in ("particles", "energy", "particle_charges"):
        np.testing.assert_allclose(_host(getattr(ours, field)), np.asarray(getattr(theirs, field)),
                                   rtol=1e-12, atol=0)
    ours = ctt.ParameterBeam.from_astra(str(path), dtype=F64, device=CPU)
    theirs = ct.ParameterBeam.from_astra(str(path), dtype=jnp.float64)
    for field in ("mu", "cov", "energy", "total_charge"):
        np.testing.assert_allclose(_host(getattr(ours, field)), np.asarray(getattr(theirs, field)),
                                   rtol=1e-12, atol=0)


def _write_sdds_file(path):
    """The ASCII SDDS beam of ``tests/test_converters.py``, two pages."""
    p_central = 300.0
    rows = [[1e-3, 0.0, 0.0, 0.0, 0.0, p_central],
            [-2e-4, 1e-4, 3e-4, -2e-4, 1e-12, 1.05 * p_central],
            [5e-4, -3e-4, -1e-4, 2e-4, -2e-12, 0.95 * p_central]]
    charges = [1e-12, 2e-12, 3e-12]
    header = ["SDDS1", "&parameter name=pCentral, type=double, &end"] + [
        f"&column name={name}, type=double, &end" for name in ("x", "xp", "y", "yp", "t", "p", "q")
    ] + ["&data mode=ascii, &end"]
    pages = []
    for scale in (1.0, 1.1):
        pages += [f"{p_central * scale}", f"{len(rows)}"] + [
            " ".join(f"{value:.17g}" for value in row[:5] + [row[5] * scale, charge])
            for row, charge in zip(rows, charges)
        ]
    path.write_text("\n".join(header + pages) + "\n")


def test_sdds_beams_match_jax(tmp_path):
    path = tmp_path / "beam.sdds"
    _write_sdds_file(path)
    ours = ctt.ParticleBeam.from_elegant(str(path), dtype=F64, device=CPU)
    theirs = ct.ParticleBeam.from_elegant(str(path), dtype=jnp.float64)
    assert tuple(ours.particles.shape) == (2, 3, 7)
    for field in ("particles", "energy", "particle_charges"):
        np.testing.assert_allclose(_host(getattr(ours, field)), np.asarray(getattr(theirs, field)),
                                   rtol=1e-12, atol=1e-18)


def test_sdds_reader_refuses_non_sdds(tmp_path):
    path = tmp_path / "not.sdds"
    path.write_text("hello\n")
    with pytest.raises(ValueError, match="not an SDDS file"):
        ctt.ParticleBeam.from_elegant(str(path), device=CPU)


# ----------------------------------------------------------------------
# Devices
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "entry_point",
    [
        lambda: ctt.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt"),
        lambda: ctt.Segment.from_elegant(RESOURCES / "fodo.lte", "fodo"),
        lambda: ctt.Segment.from_bmad(RESOURCES / "bmad_tutorial_lattice.bmad"),
        lambda: ctt.Segment.from_ocelot([OCELOT_CASES["drift"]]),
        lambda: ctt.ParticleBeam.from_ocelot(_ParticleArray(1)),
        lambda: ctt.ParameterBeam.from_ocelot(_ParticleArray(1)),
    ],
    ids=["nx_tables", "elegant", "bmad", "ocelot", "particle_beam_ocelot",
         "parameter_beam_ocelot"],
)
def test_converters_default_to_the_card(entry_point):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _quiet(entry_point)
