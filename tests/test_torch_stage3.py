"""The full ARES stage-3 lattice in the PyTorch port against cheetah_tpu on
the CPU, in float64: ``lattices.ares_stage3`` (the package's own LatticeJSON),
LatticeJSON written by either package and loaded by the other,
``Segment.set_attrs_on_every_element``, and the reference's own benchmark
workload (``tests/test_full_ares.py``): the lattice tracked as a
``ParticleBeam`` in linear, second-order and drift-kick-drift mode and as a
``ParameterBeam`` in linear mode.

The vendored magnets are all at zero strength, so both packages set them
from one numpy ``Generator``: every quadrupole's ``k1`` in [-5, 5] 1/m^2,
both solenoids' ``k`` in [-1, 1] 1/m and every corrector angle in +-1e-4
rad, with the seed and the draws of ``chip_smoke.py``'s stage-3 phase. At
these strengths the lattice is not stable (the beam grows ~1000-fold), and
for some seeds a tail particle leaves the drift-kick-drift maps' domain
(|px| > 1 + pz), non-finite in both packages alike; the tests assert that
every outgoing particle here is finite, so that the comparison holds
numbers. The beam is 1000 particles drawn with numpy. Tolerances are those of
the JAX package against its reference (``tests/test_full_ares.py:174-180``):
particles rtol 1e-9 with atol 1e-12, energy rtol 1e-12. The JAX side runs
eagerly and once per module: compiling the second-order lattice takes
minutes on the CPU, tracking it eagerly seconds.
"""

import json
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_stage3 as jax_ares_stage3
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.lattices import ares_stage3
from cheetah_tpu_torch.utils.warnings import PhysicsWarning

REPO = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
CPU = "cpu"
SEED = 0
NUM_PARTICLES = 1000
ENERGY = 1.54e8
RTOL, ATOL, ENERGY_RTOL = 1e-9, 1e-12, 1e-12
MODES = ["linear", "second_order", "drift_kick_drift"]
# Plan entries of each mode (the same in both packages): the three active
# apertures split the linear lattice into 7; second-order and
# drift-kick-drift elements are tracked one by one.
PLAN_LENGTHS = {"linear": 7, "second_order": 111, "drift_kick_drift": 181}
CORRECTORS = ("HorizontalCorrector", "VerticalCorrector")


def magnet_settings() -> dict:
    """Seeded strengths, by element type, in the lattice's order."""
    rng = np.random.default_rng(SEED)
    return {
        "Quadrupole": ("k1", rng.uniform(-5.0, 5.0, size=13)),
        "Solenoid": ("k", rng.uniform(-1.0, 1.0, size=2)),
        "corrector": ("angle", rng.uniform(-1e-4, 1e-4, size=30)),
    }


def configure(segment, to_array) -> None:
    """Set the seeded strengths on ``segment``'s magnets."""
    settings = magnet_settings()
    counts = dict.fromkeys(settings, 0)
    for element in segment.elements:
        kind = type(element).__name__
        kind = "corrector" if kind in CORRECTORS else kind
        if kind in settings:
            attribute, values = settings[kind]
            setattr(element, attribute, to_array(values[counts[kind]]))
            counts[kind] += 1
    assert counts == {"Quadrupole": 13, "Solenoid": 2, "corrector": 30}


def set_mode(segment, mode: str) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PhysicsWarning)  # the per-element fallbacks
        segment.set_attrs_on_every_element(tracking_method=mode, num_steps=5)


def jax_lattice(mode="linear"):
    segment = jax_ares_stage3(dtype=jnp.float64)
    configure(segment, lambda v: jnp.asarray(v, jnp.float64))
    set_mode(segment, mode)
    return segment


def lattice(mode="linear"):
    segment = ares_stage3(F64, device=CPU)
    configure(segment, lambda v: torch.tensor(v, dtype=F64))
    set_mode(segment, mode)
    return segment


def particles_in() -> np.ndarray:
    rng = np.random.default_rng(SEED + 1)
    phase_space = rng.normal(0.0, [1e-4, 1e-5, 1e-4, 1e-5, 1e-5, 1e-3], size=(NUM_PARTICLES, 6))
    return np.concatenate([phase_space, np.ones((NUM_PARTICLES, 1))], axis=1)


def beams():
    particles = particles_in()
    return (
        ct.ParticleBeam(particles=jnp.asarray(particles), energy=jnp.asarray(ENERGY)),
        ctt.ParticleBeam(torch.tensor(particles), torch.tensor(ENERGY, dtype=F64)),
    )


PARAMETER_MOMENTS = dict(mu_x=1e-4, mu_px=-2e-5, sigma_x=1.7e-4, sigma_px=4e-6, sigma_y=1.7e-4,
                         sigma_py=4e-6, sigma_tau=1e-5, sigma_p=1e-3, cov_xpx=1e-10,
                         energy=ENERGY, total_charge=1e-9)


def parameter_beams():
    return (
        ct.ParameterBeam.from_parameters(
            **{k: jnp.asarray(v, jnp.float64) for k, v in PARAMETER_MOMENTS.items()}
        ),
        ctt.ParameterBeam.from_parameters(**PARAMETER_MOMENTS, dtype=F64, device=CPU),
    )


@pytest.fixture(scope="module")
def jax_results() -> dict:
    """The JAX package's outgoing beams, computed once: eagerly, fused, in
    every mode, and element by element in linear mode."""
    jax_beam, _ = beams()
    results = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ParameterBeam through apertures
        for mode in MODES:
            segment = jax_lattice(mode)
            results[mode] = (segment.track(jax_beam), [type(t).__name__ for t in segment._plan()])
        segment = jax_lattice()
        results["parameter"] = segment.track(parameter_beams()[0])
        elementwise = jax_beam
        for element in segment.elements:
            elementwise = element.track(elementwise)
        results["elementwise"] = elementwise
    return results


def assert_particles_close(actual, expected) -> None:
    np.testing.assert_allclose(actual.particles.numpy(), np.asarray(expected.particles),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(actual.energy.numpy(), np.asarray(expected.energy),
                               rtol=ENERGY_RTOL)
    np.testing.assert_array_equal(actual.survival_probabilities.numpy(),
                                  np.asarray(expected.survival_probabilities))


# ---------------------------------------------------------------------------
# The lattice
# ---------------------------------------------------------------------------


def test_stage3_structure_matches_jax():
    segment, jax_segment = ares_stage3(F64, device=CPU), jax_ares_stage3(dtype=jnp.float64)
    assert len(segment.elements) == len(jax_segment.elements) == 195
    assert segment.element_names == jax_segment.element_names
    assert [type(e).__name__ for e in segment.elements] == [
        type(e).__name__ for e in jax_segment.elements
    ]
    np.testing.assert_allclose(float(segment.length), float(jax_segment.length), rtol=1e-14)
    resource = REPO / "cheetah_tpu_torch" / "resources" / "ares_stage3.json"
    assert resource.read_bytes() == (REPO / "cheetah_tpu" / "resources" / "ares_stage3.json"
                                     ).read_bytes()


def test_stage3_defaults_to_float32_and_the_elements_hold_their_settings():
    segment = ares_stage3(device=CPU)
    assert all(buffer.dtype == torch.float32 for buffer in segment.buffers())
    assert all(buffer.device.type == "cpu" for buffer in segment.buffers())
    solenoid = segment.ARLIMSOG1A
    assert isinstance(solenoid, ctt.Solenoid) and solenoid.k.item() == 0.0
    screen = segment.AREABSCR1
    assert screen.resolution == (2448, 2040) and screen.binning == 1 and not screen.is_active
    assert segment.ARLIRSBL1.cavity_type == "standing_wave" and segment.ARLIRSBL1.is_skippable
    assert segment.ARSHMBHO1.fringe_at == "both"
    aperture = segment.ARLISLHG1
    assert aperture.is_active and aperture.shape == "rectangular"
    assert torch.isinf(aperture.x_max)


def test_a_name_given_twice_is_two_modules():
    segment = ares_stage3(F64, device=CPU)
    drifts = segment.Drift_ARMRMQZM1
    assert isinstance(drifts, list) and len(drifts) == 5
    assert len({id(drift) for drift in drifts}) == 5
    drifts[0].length = 1.0
    assert all(drift.length.item() != 1.0 for drift in drifts[1:])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_writes_the_same_lattice_json_bytes_as_jax(tmp_path, dtype):
    ares_stage3(getattr(torch, dtype), device=CPU).to_lattice_json(str(tmp_path / "port.json"))
    jax_ares_stage3(dtype=getattr(jnp, dtype)).to_lattice_json(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_stage3_tracking_matches_jax(jax_results, mode):
    jax_beam, beam = beams()
    segment = lattice(mode)
    expected, jax_plan = jax_results[mode]
    plan = [type(todo).__name__ for todo in segment._plan()]
    assert plan == jax_plan and len(plan) == PLAN_LENGTHS[mode]
    out = segment.track(beam)
    assert out.particles.shape == (NUM_PARTICLES, 7)
    assert bool(torch.isfinite(out.particles).all())
    assert_particles_close(out, expected)


def test_stage3_parameter_beam_matches_jax(jax_results):
    _, beam = parameter_beams()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ParameterBeam through apertures
        out = lattice().track(beam)
    expected = jax_results["parameter"]
    np.testing.assert_allclose(out.mu.numpy(), np.asarray(expected.mu), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.cov.numpy(), np.asarray(expected.cov), rtol=RTOL, atol=1e-24)
    np.testing.assert_allclose(out.sigma_x.item(), float(expected.sigma_x), rtol=RTOL)
    np.testing.assert_allclose(out.energy.numpy(), np.asarray(expected.energy),
                               rtol=ENERGY_RTOL)


def test_stage3_elementwise_matches_jax_and_the_fused_track(jax_results):
    """Element by element against element by element. Fused and element-wise
    tracking differ by the zero-voltage cavities' model (their own ``track``
    and their linear map differ by ~1.6e-8), ~4e-8 in both packages."""
    _, beam = beams()
    segment = lattice()
    out = beam
    for element in segment.elements:
        out = element.track(out)
    assert_particles_close(out, jax_results["elementwise"])
    fused = segment.track(beam)
    np.testing.assert_allclose(out.particles.numpy(), fused.particles.numpy(), atol=1e-7)


def test_stage3_k1_gradient_matches_jax():
    """d sigma_x at the end of the lattice by AREAMQZM1.k1, linear mode."""
    jax_beam, beam = beams()
    k1 = float(magnet_settings()["Quadrupole"][1][0])

    def jax_sigma_x(value):
        segment = jax_lattice()
        segment.AREAMQZM1.k1 = value
        return segment.track(jax_beam).sigma_x

    expected = jax.grad(jax_sigma_x)(jnp.asarray(k1, jnp.float64))
    segment = lattice()
    parameter = torch.tensor(k1, dtype=F64, requires_grad=True)
    segment.AREAMQZM1.k1 = parameter
    (grad,) = torch.autograd.grad(segment.track(beam).sigma_x, parameter)
    assert float(expected) != 0.0
    np.testing.assert_allclose(grad.item(), float(expected), rtol=1e-9)


# ---------------------------------------------------------------------------
# LatticeJSON across the two packages
# ---------------------------------------------------------------------------


def test_lattice_json_round_trips_between_the_packages(tmp_path):
    jax_beam, beam = beams()
    lattice().to_lattice_json(str(tmp_path / "port.json"))
    jax_lattice().to_lattice_json(str(tmp_path / "jax.json"))
    from_port = ct.Segment.from_lattice_json(str(tmp_path / "port.json"), dtype=jnp.float64)
    from_jax = ctt.Segment.from_lattice_json(str(tmp_path / "jax.json"), dtype=F64, device=CPU)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    expected = jax_lattice().track(jax_beam)
    assert_particles_close(from_jax.track(beam), expected)
    np.testing.assert_array_equal(np.asarray(from_port.track(jax_beam).particles),
                                  np.asarray(expected.particles))


def _zoo(module, a, **kw):
    """A lattice with every element type that LatticeJSON must carry: the
    new elements, a nested segment and a Superimposed element."""
    return module.Segment(
        [
            module.Solenoid(a(0.3), k=a(1.5), misalignment=a([1e-4, 0.0]), name="sol", **kw),
            module.Undulator(a(1.0), period=a(0.05), kx=a(0.8), name="und", **kw),
            module.CombinedCorrector(a(0.1), horizontal_angle=a(1e-4), vertical_angle=a(-2e-4),
                                     name="ccor", **kw),
            module.RBend(a(0.5), angle=a(0.2), rbend_e1=a(0.05), rbend_e2=a(-0.02),
                         tracking_method="second_order", name="rbend", **kw),
            module.TransverseDeflectingCavity(a(0.6), voltage=a(1e6), phase=a(0.1),
                                              frequency=a(2.9e9), num_steps=3, name="tdc", **kw),
            module.CustomTransferMap(a(np.eye(7) + np.diag([0.1] * 6, 1)), length=a(0.2),
                                     name="ctm", **kw),
            module.Segment([module.Drift(a(0.2), name="inner_drift", **kw),
                            module.Quadrupole(a(0.1), k1=a(3.0), name="inner_quad", **kw)],
                           name="inner"),
            module.Superimposed(module.Quadrupole(a(0.3), k1=a(-2.0), name="base", **kw),
                                module.VerticalCorrector(a(0.0), angle=a(1e-4), name="centre",
                                                         **kw),
                                name="sup"),
        ],
        name="zoo",
    )


def test_lattice_json_carries_every_element_type(tmp_path):
    jax_beam, beam = beams()
    kw = {"dtype": F64, "device": CPU}
    _zoo(ctt, lambda v: torch.tensor(v, dtype=F64), **kw).to_lattice_json(
        str(tmp_path / "port.json")
    )
    jax_zoo = _zoo(ct, lambda v: jnp.asarray(v, jnp.float64))
    jax_zoo.to_lattice_json(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    lattice_dict = json.loads((tmp_path / "port.json").read_text())
    assert lattice_dict["elements"]["sup"][1]["base_element"] == "base"
    assert lattice_dict["elements"]["tdc"][1]["num_steps"] == 3

    loaded = ctt.Segment.from_lattice_json(str(tmp_path / "jax.json"), dtype=F64, device=CPU)
    assert [type(e).__name__ for e in loaded.elements] == [
        type(e).__name__ for e in jax_zoo.elements
    ]
    assert loaded.rbend.tracking_method == "second_order" and loaded.tdc.num_steps == 3
    assert isinstance(loaded.sup.base_element, ctt.Quadrupole)
    expected = jax_zoo.track(jax_beam)
    np.testing.assert_allclose(loaded.track(beam).particles.numpy(),
                               np.asarray(expected.particles), rtol=RTOL, atol=ATOL)
    back = ct.Segment.from_lattice_json(str(tmp_path / "port.json"), dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(back.track(jax_beam).particles),
                                  np.asarray(expected.particles))


# ---------------------------------------------------------------------------
# set_attrs_on_every_element
# ---------------------------------------------------------------------------


def test_solenoid_falls_back_to_linear_with_a_warning():
    segment = ctt.Segment([ctt.Solenoid(0.3, name="sol", dtype=F64, device=CPU)])
    with pytest.warns(PhysicsWarning, match="Invalid tracking method"):
        segment.set_attrs_on_every_element(tracking_method="drift_kick_drift")
    assert segment.sol.tracking_method == "linear"


def _nested():
    kw = {"dtype": F64, "device": CPU}
    inner = ctt.Segment([ctt.Quadrupole(0.1, name="q_inner", **kw), ctt.Drift(0.2, **kw)],
                        name="inner")
    return ctt.Segment([ctt.Quadrupole(0.1, name="q_outer", **kw), inner,
                        ctt.Drift(0.3, name="d_outer", **kw)])


@pytest.mark.parametrize("is_recursive", [True, False])
def test_set_attrs_filters_by_type_and_recursion(is_recursive):
    segment = _nested()
    segment.set_attrs_on_every_element(filter_type=ctt.Quadrupole, is_recursive=is_recursive,
                                       k1=2.5)
    assert segment.q_outer.k1.item() == 2.5
    assert segment.q_outer.k1.dtype == F64
    assert segment.inner.q_inner.k1.item() == (2.5 if is_recursive else 0.0)
    assert not hasattr(segment.d_outer, "k1")


def test_set_attrs_with_a_tuple_of_types_and_without_a_filter():
    segment = _nested()
    segment.set_attrs_on_every_element(filter_type=(ctt.Drift, ctt.Segment), num_steps=4)
    assert segment.d_outer.num_steps == 4
    # A selected segment gets the attribute itself; its elements do not.
    assert segment.inner.num_steps == 4
    assert not hasattr(segment.inner.elements[1], "num_steps")
    assert segment.q_outer.num_steps == 1
    with pytest.warns(PhysicsWarning, match="Segment"):
        segment.set_attrs_on_every_element(tracking_method="drift_kick_drift")
    assert segment.q_outer.tracking_method == "drift_kick_drift"
    assert segment.d_outer.tracking_method == "drift_kick_drift"
    assert segment.inner.elements[0].tracking_method == "linear"
