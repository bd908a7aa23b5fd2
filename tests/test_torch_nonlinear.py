"""The nonlinear slice of the PyTorch port against cheetah_tpu on the CPU, in
float64: the maths primitives of the second-order map, the cavity and the
Bmad-X maps, ``base_ttensor``, Cavity, Dipole and Sextupole, the
second-order bracket fusion and its Gaussian closure, BASELINE config 3 (the
nonlinear chain of ``scripts/bench_all.py:379-410``) end to end, the
drift-kick-drift maps against the stored Bmad-X ground truth, and the
chain's gradients against ``jax.grad``.

The same inputs, made with numpy from a seed, go through both packages; the
JAX side runs under ``jax.jit``. Both packages evaluate the same closed
forms in the same order, so they agree to a few ulps of each quantity, and
the tolerances below are stated where they are used.
"""

import math
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
from cheetah_tpu.ops import transfer_maps as jax_maps
from cheetah_tpu.utils import bmadx as jax_bmadx
from cheetah_tpu.utils import maths as jax_maths
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.ops import transfer_maps
from cheetah_tpu_torch.utils import bmadx, maths
from cheetah_tpu_torch.utils.warnings import PhysicsWarning
from test_torch_tracking import beam_to_torch, segment_to_torch

F64 = torch.float64
CPU = "cpu"
RESOURCES = pathlib.Path(__file__).parent / "resources"
ASTRA_BEAM = RESOURCES / "ACHIP_EA1_2021.1351.001_subsampled_3000.pkl"
BMADX = RESOURCES / "bmad" / "bmadx_dkd_ground_truth.npz"

# ---------------------------------------------------------------------------
# maths
# ---------------------------------------------------------------------------

# Both packages evaluate the same closed forms. The rules divide differences
# of O(1) numbers by x or x^2 near 0, losing eps / x^2 (2e-12 absolute at
# |x| = 1e-2; the values, which divide once, eps / x); the small points stay
# at |x| = 1e-2, and the tolerances are rtol 1e-9 with atol 1e-11 on values
# and first derivatives. At 0 exactly
# both packages give the analytic limits.
UNARY_POINTS = np.array([0.0, 1e-2, -1e-2, 0.3, -0.3, 2.5, -4.0, 30.0, -30.0])
UNARY = {
    "log1pdiv": UNARY_POINTS[UNARY_POINTS > -0.9],
    "sicos1mdiv": UNARY_POINTS,
    "sipsicos3mdiv": UNARY_POINTS,
}
# (a, b) pairs: both zero, one zero, equal, both signs, nearly equal.
PAIR_A = np.array([0.0, 0.0, 0.7, 0.7, -2.0, 0.3, 1e-2, 2.5, -1.5])
PAIR_B = np.array([0.0, 0.9, 0.0, 0.7, 0.5, -0.7, 1e-2, 2.51, -1.5])
BINARY = ("cossqrtmcosdivdiff", "simsidivdiff", "si2msi2divdiff")
SQRT_A = np.array([1.0, 0.9, 1.2, 0.5, 2.0])
SQRT_B = np.array([0.0, 1e-2, -0.2, 0.3, -1e-2])
MATHS_RTOL, MATHS_ATOL = 1e-9, 1e-11


def _np(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().numpy()


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_primitive_values_and_gradients_match_jax(name):
    points = UNARY[name]
    jax_function = getattr(jax_maths, name)
    x = torch.tensor(points, dtype=F64, requires_grad=True)
    value = getattr(maths, name)(x)
    (grad,) = torch.autograd.grad(value.sum(), x)
    np.testing.assert_allclose(
        _np(value), np.asarray(jax.jit(jax_function)(jnp.asarray(points))),
        rtol=MATHS_RTOL, atol=MATHS_ATOL,
    )
    expected = jax.jit(jax.vmap(jax.grad(jax_function)))(jnp.asarray(points))
    np.testing.assert_allclose(_np(grad), np.asarray(expected), rtol=MATHS_RTOL, atol=MATHS_ATOL)
    assert np.all(np.isfinite(_np(grad)))


@pytest.mark.parametrize("name", BINARY)
def test_binary_primitive_values_and_gradients_match_jax(name):
    jax_function = getattr(jax_maths, name)
    a = torch.tensor(PAIR_A, dtype=F64, requires_grad=True)
    b = torch.tensor(PAIR_B, dtype=F64, requires_grad=True)
    value = getattr(maths, name)(a, b)
    grads = torch.autograd.grad(value.sum(), (a, b))
    expected_value = jax.jit(jax_function)(jnp.asarray(PAIR_A), jnp.asarray(PAIR_B))
    expected_grads = jax.jit(jax.vmap(jax.grad(jax_function, argnums=(0, 1))))(
        jnp.asarray(PAIR_A), jnp.asarray(PAIR_B)
    )
    np.testing.assert_allclose(
        _np(value), np.asarray(expected_value), rtol=MATHS_RTOL, atol=MATHS_ATOL
    )
    for grad, expected in zip(grads, expected_grads):
        np.testing.assert_allclose(
            _np(grad), np.asarray(expected), rtol=MATHS_RTOL, atol=MATHS_ATOL
        )


def test_sqrta2minusbdiva_values_and_gradients_match_jax():
    a = torch.tensor(SQRT_A, dtype=F64, requires_grad=True)
    b = torch.tensor(SQRT_B, dtype=F64, requires_grad=True)
    value = maths.sqrta2minusbdiva(a, b)
    grads = torch.autograd.grad(value.sum(), (a, b))
    args = (jnp.asarray(SQRT_A), jnp.asarray(SQRT_B))
    np.testing.assert_allclose(
        _np(value), np.asarray(jax.jit(jax_maths.sqrta2minusbdiva)(*args)), rtol=1e-14
    )
    expected = jax.jit(jax.vmap(jax.grad(jax_maths.sqrta2minusbdiva, argnums=(0, 1))))(*args)
    for grad, want in zip(grads, expected):
        np.testing.assert_allclose(_np(grad), np.asarray(want), rtol=MATHS_RTOL, atol=MATHS_ATOL)
    # The limit at b = 0 is 1 / (2a), with derivatives -1/(2a^2) and -1/(8a^3).
    assert value[0].item() == 0.5 and grads[1][0].item() == pytest.approx(-0.125, rel=1e-15)


@pytest.mark.parametrize("output", range(4))
def test_cos_sinc_sqrt_pm_values_and_gradients_match_jax(output):
    points = UNARY_POINTS
    x = torch.tensor(points, dtype=F64, requires_grad=True)
    value = maths.cos_sinc_sqrt_pm(x)[output]
    (grad,) = torch.autograd.grad(value.sum(), x)
    expected_value = jax.jit(jax_maths.cos_sinc_sqrt_pm)(jnp.asarray(points))[output]
    expected_grad = jax.jit(
        jax.vmap(jax.grad(lambda t: jax_maths.cos_sinc_sqrt_pm(t)[output]))
    )(jnp.asarray(points))
    np.testing.assert_allclose(_np(value), np.asarray(expected_value), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(
        _np(grad), np.asarray(expected_grad), rtol=MATHS_RTOL, atol=MATHS_ATOL
    )
    # The quartet equals the four single functions.
    single = (
        maths.cos_sqrt(x), maths.sinc_sqrt(x), maths.cos_sqrt(-x), maths.sinc_sqrt(-x)
    )[output]
    np.testing.assert_allclose(_np(value), _np(single), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cos_sinc_sqrt_series_pm_matches_jax_and_exact(dtype):
    """The series equals the JAX package's (same terms, same order: a few
    ulps) and the exact quartet to the dtype's precision for |t| <= 256."""
    t = np.concatenate([np.linspace(-256.0, 256.0, 41), [0.0, 1e-6, -1e-6]])
    t_torch = torch.tensor(t, dtype=dtype)
    got = torch.stack(maths.cos_sinc_sqrt_series_pm(t_torch))
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = np.stack(jax.jit(jax_maths.cos_sinc_sqrt_series_pm)(jnp.asarray(t, jax_dtype)))
    eps = float(torch.finfo(dtype).eps)
    np.testing.assert_allclose(_np(got), want, rtol=16 * eps, atol=16 * eps)
    exact = torch.stack(maths.cos_sinc_sqrt_pm(torch.tensor(t, dtype=F64)))
    # cosh(16) ~ 4e6: the exact quartet's scale sets the absolute tolerance.
    scale = exact.abs().clamp(min=1.0)
    assert torch.all((got.double() - exact).abs() <= 1e3 * eps * scale)


# ---------------------------------------------------------------------------
# utils/bmadx.py
# ---------------------------------------------------------------------------


def _bmadx_arguments():
    """numpy arguments of every function of ``utils/bmadx.py``: two
    instances of 50 electrons at 154 and 20 MeV, pz across both branches of
    ``low_energy_z_correction`` (its switch sits at |pz| ~ 1e-2 at 154 MeV)."""
    rng = np.random.default_rng(11)
    n = 50
    ref_energy = np.array([1.54e8, 2.0e7])
    mc2 = np.asarray(ct.Species("electron").mass_eV)
    p0c = np.sqrt(ref_energy**2 - mc2**2)
    x, px, y, py = (rng.normal(scale=1e-3, size=(2, n)) for _ in range(4))
    tau, z = (rng.normal(scale=1e-4, size=(2, n)) for _ in range(2))
    pz = np.sign(rng.normal(size=(2, n))) * np.logspace(-5, -1, n)
    coords = np.concatenate(
        [np.stack([x, px, y, py, tau, pz / 2], -1), np.ones((2, n, 1))], axis=-1
    )
    offsets = (np.array([1e-4, -2e-4]), np.array([3e-4, 0.0]), np.array([0.3, 0.0]))
    k1 = np.array([[-12.0], [0.0]]) * np.ones((2, n)) / (1 + pz)
    length = np.array([0.3, 0.2])
    return {
        "cheetah_to_bmad_z_pz": (tau, pz / 2, ref_energy, mc2),
        "bmad_to_cheetah_z_pz": (z, pz, p0c, mc2),
        "cheetah_to_bmad_coords": (coords, ref_energy, mc2),
        "bmad_to_cheetah_coords": (coords[..., :6], p0c, mc2),
        "offset_particle_set": (*offsets, x, px, y, py),
        "offset_particle_unset": (*offsets, x, px, y, py),
        "low_energy_z_correction": (pz, p0c, mc2, length),
        "calculate_quadrupole_coefficients": (k1, length, 1 + pz),
        "calculate_quadrupole_coefficients_both": (k1, length, 1 + pz),
        "calculate_quadrupole_coefficients_chromatic": (np.array([[-12.0], [3.0]]), length, pz),
        "sqrt_one": (pz,),
        "track_a_drift": (length, x, px, y, py, z, pz, p0c, mc2),
        "particle_rf_time": (z, pz, p0c, mc2),
        "sinc": (np.array([0.0, 1e-8, -0.3, 2.0, 40.0]),),
        "cosc": (np.array([0.0, 1e-8, -0.3, 2.0, 40.0]),),
    }


@pytest.mark.parametrize("name", sorted(_bmadx_arguments()))
def test_bmadx_functions_match_jax(name):
    """Every function of ``utils/bmadx.py`` against the JAX package's on the
    same arrays: a few dozen operations each, rtol 1e-12 of each output's
    largest entry (the Bmad round trips subtract O(1) numbers: an absolute
    1e-15 besides)."""
    arguments = _bmadx_arguments()[name]
    got = getattr(bmadx, name)(*(torch.tensor(a) for a in arguments))
    want = jax.jit(getattr(jax_bmadx, name))(*(jnp.asarray(a) for a in arguments))
    got_leaves = [_np(t) for t in jax.tree_util.tree_leaves(got)]
    want_leaves = [np.asarray(t) for t in jax.tree_util.tree_leaves(want)]
    assert len(got_leaves) == len(want_leaves)
    for actual, expected in zip(got_leaves, want_leaves):
        assert actual.shape == expected.shape
        np.testing.assert_allclose(
            actual, expected, rtol=0, atol=1e-12 * float(np.abs(expected).max()) + 1e-15
        )


# ---------------------------------------------------------------------------
# base_ttensor and the elements' second-order maps
# ---------------------------------------------------------------------------

TTENSOR_CASES = {
    # (length, k1, k2, hx): the drift, a quadrupole of either sign, a
    # sextupole, a bend, a bend with gradient, and k1 = 0 / hx = 0 mixed in
    # one vectorised call.
    "drift": (0.7, 0.0, 0.0, 0.0),
    "quadrupole": (0.3, [4.0, -6.0, 0.0], 0.0, 0.0),
    "sextupole": (0.2, 0.0, [60.0, -15.0], 0.0),
    "dipole": (0.4, 0.0, 0.0, 0.375),
    "combined": (0.4, [2.0, 0.0], [5.0, 0.0], [0.375, 0.0]),
}


@pytest.mark.parametrize("case", sorted(TTENSOR_CASES))
def test_base_ttensor_matches_jax(case):
    length, k1, k2, hx = (np.asarray(v, dtype=np.float64) for v in TTENSOR_CASES[case])
    energy = np.asarray([1.2e8, 1.54e8, 1e9])[:, None] if case == "drift" else np.asarray(1.54e8)
    expected = jax.jit(
        lambda length, k1, k2, hx, energy: jax_maps.base_ttensor(
            length, k1, k2, hx, ct.Species("electron"), energy
        )
    )(*(jnp.asarray(v) for v in (length, k1, k2, hx, energy)))
    got = transfer_maps.base_ttensor(
        *(torch.tensor(v) for v in (length, k1, k2, hx)),
        ctt.Species("electron", dtype=F64, device=CPU),
        torch.tensor(energy),
    )
    assert got.shape == expected.shape
    # Entries are closed forms of a few dozen operations, divided by up to
    # kx2^3 (j3); rtol 1e-12 of the largest entry.
    np.testing.assert_allclose(
        _np(got), np.asarray(expected), rtol=0, atol=1e-12 * float(np.abs(expected).max())
    )


def _element_pairs():
    """JAX elements with a second-order map, with misalignments and tilts."""
    kw = {"dtype": jnp.float64}
    return {
        "drift": ct.Drift(jnp.asarray(0.5), tracking_method="second_order", **kw),
        "quadrupole": ct.Quadrupole(
            jnp.asarray(0.3), k1=jnp.asarray(4.5), misalignment=jnp.asarray([1e-4, -2e-4]),
            tilt=jnp.asarray(0.1), tracking_method="second_order", **kw,
        ),
        "dipole": ct.Dipole(
            jnp.asarray(0.4), angle=jnp.asarray(0.15), k1=jnp.asarray(0.8),
            dipole_e1=jnp.asarray(0.05), dipole_e2=jnp.asarray(0.07), tilt=jnp.asarray(0.2),
            gap=jnp.asarray(0.03), fringe_integral=jnp.asarray(0.4),
            tracking_method="second_order", **kw,
        ),
        "sextupole": ct.Sextupole(
            jnp.asarray(0.2), k2=jnp.asarray(60.0), misalignment=jnp.asarray([2e-4, 1e-4]),
            tilt=jnp.asarray(-0.3), **kw,
        ),
    }


@pytest.mark.parametrize("name", ["drift", "quadrupole", "dipole", "sextupole"])
def test_second_order_transfer_maps_match_jax(name):
    jax_element = _element_pairs()[name]
    port = segment_to_torch(ct.Segment([jax_element])).elements[0]
    energy = 1.54e8
    expected = jax.jit(
        lambda e, s: e.second_order_transfer_map(s, ct.Species("electron"))
    )(jax_element, jnp.asarray(energy))
    got = port.second_order_transfer_map(
        torch.tensor(energy, dtype=F64), ctt.Species("electron", dtype=F64, device=CPU)
    )
    np.testing.assert_allclose(
        _np(got), np.asarray(expected), rtol=0, atol=1e-12 * float(np.abs(expected).max())
    )
    assert port.tracking_method == "second_order" and not port.is_skippable


# ---------------------------------------------------------------------------
# Beams and the element tracking comparisons
# ---------------------------------------------------------------------------


def _beam_arrays(num_particles=2000, seed=0, energy=1.54e8, sigma_p=1e-3):
    """A Gaussian beam made with numpy: x, y of 0.1 mm, angles of 0.1 mrad,
    tau of 10 um and ``sigma_p``, with an x-px correlation."""
    rng = np.random.default_rng(seed)
    particles = np.zeros((num_particles, 7))
    particles[:, :6] = rng.normal(size=(num_particles, 6)) * [1e-4, 1e-4, 1e-4, 1e-4, 1e-5, sigma_p]
    particles[:, 1] += 0.3 * particles[:, 0] / 1e0
    particles[:, 6] = 1.0
    charges = np.full(num_particles, 1e-10 / num_particles)
    return particles, np.asarray(energy), charges


def _jax_beam(particles, energy, charges):
    return ct.ParticleBeam(
        particles=jnp.asarray(particles), energy=jnp.asarray(energy),
        particle_charges=jnp.asarray(charges),
    )


def _jax_track(segment, beam):
    return jax.jit(lambda s, b: s.track(b))(segment, beam)


# Tracked coordinates: rtol 1e-9 of each coordinate's largest value (the
# maps chain a few dozen operations per particle). The Bmad-X round trip
# of the drift-kick-drift maps computes delta = (E - E_ref) / p0c, which
# cancels to an absolute few ulps of 1 (the JAX package shares it), so p
# also gets an absolute 1e-14.
PARTICLE_RTOL = 1e-9
P_ATOL = 1e-14


def _assert_particles(actual: torch.Tensor, expected, rtol=PARTICLE_RTOL):
    actual, expected = _np(actual), np.asarray(expected)
    assert actual.shape == expected.shape
    for column in range(7):
        want = expected[..., column]
        atol = rtol * float(np.abs(want).max()) + (P_ATOL if column == 5 else 0.0)
        np.testing.assert_allclose(
            actual[..., column], want, rtol=0, atol=atol, err_msg=f"column {column}"
        )


def _cavity(cavity_type, voltage, phase=30.0):
    return ct.Cavity(
        jnp.asarray(1.0), voltage=jnp.asarray(voltage), phase=jnp.asarray(phase),
        frequency=jnp.asarray(1.3e9), cavity_type=cavity_type, name="cav", dtype=jnp.float64,
    )


@pytest.mark.parametrize("cavity_type", ["standing_wave", "traveling_wave"])
@pytest.mark.parametrize("voltage", [2e7, -1e7], ids=["accelerating", "decelerating"])
def test_cavity_tracks_particle_beam_like_jax(cavity_type, voltage):
    segment = ct.Segment([_cavity(cavity_type, voltage)])
    beam = _jax_beam(*_beam_arrays())
    expected = _jax_track(segment, beam)
    got = segment_to_torch(segment).track(beam_to_torch(beam))
    _assert_particles(got.particles, expected.particles)
    assert got.energy.item() == pytest.approx(float(expected.energy), rel=1e-15)
    assert got.s.item() == pytest.approx(1.0, rel=1e-15)


@pytest.mark.parametrize("cavity_type", ["standing_wave", "traveling_wave"])
@pytest.mark.parametrize("voltage", [2e7, -1e7], ids=["accelerating", "decelerating"])
def test_cavity_tracks_parameter_beam_like_jax(cavity_type, voltage):
    segment = ct.Segment([_cavity(cavity_type, voltage)])
    beam = _jax_beam(*_beam_arrays()).as_parameter_beam()
    expected = jax.jit(lambda s, b: s.track(b))(segment, beam)
    port_beam = ctt.ParameterBeam(
        torch.tensor(np.asarray(beam.mu)), torch.tensor(np.asarray(beam.cov)),
        torch.tensor(np.asarray(beam.energy)), total_charge=torch.tensor(1e-10, dtype=F64),
    )
    got = segment_to_torch(segment).track(port_beam)
    # A 7x7 congruence and the longitudinal terms: rtol 1e-10 of the largest
    # entry of each.
    for actual, want in ((got.mu, expected.mu), (got.cov, expected.cov)):
        np.testing.assert_allclose(
            _np(actual), np.asarray(want), rtol=0, atol=1e-10 * float(np.abs(want).max())
        )
    assert got.energy.item() == pytest.approx(float(expected.energy), rel=1e-15)


def test_cavity_skippable_decided_on_the_host():
    """An idle cavity fuses into the linear run; assigning a voltage (or one
    that needs a gradient) makes it track on its own, and a zero-crossing
    phase warns. The decision is a Python bool kept on the element."""
    cavity = ctt.Cavity(1.0, voltage=0.0, phase=30.0, frequency=1.3e9, dtype=F64, device=CPU)
    segment = ctt.Segment([ctt.Drift(0.2, dtype=F64, device=CPU), cavity])
    assert cavity.is_skippable and segment.is_skippable
    cavity.voltage = 1e6
    assert not cavity.is_skippable
    assert [type(t).__name__ for t in segment._plan()] == ["Segment", "Cavity"]
    cavity.voltage = torch.tensor(0.0, dtype=F64, requires_grad=True)
    assert not cavity.is_skippable
    cavity.voltage = 0.0
    assert cavity.is_skippable
    cavity.skippable_when_off = False
    assert not cavity.is_skippable
    with pytest.warns(PhysicsWarning, match="zero-crossing"):
        ctt.Cavity(1.0, voltage=1e6, phase=90.0, frequency=1.3e9, dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="cavity type"):
        ctt.Cavity(1.0, cavity_type="superconducting", dtype=F64, device=CPU)


def _dipole(method, tilt=0.1, fringe_at="both"):
    return ct.Dipole(
        jnp.asarray(0.5), angle=jnp.asarray(20 * math.pi / 180),
        dipole_e1=jnp.asarray(0.08), dipole_e2=jnp.asarray(0.12), tilt=jnp.asarray(tilt),
        gap=jnp.asarray(0.05), gap_exit=jnp.asarray(0.04),
        fringe_integral=jnp.asarray(0.5), fringe_integral_exit=jnp.asarray(0.4),
        fringe_at=fringe_at, tracking_method=method, name="dip", dtype=jnp.float64,
    )


@pytest.mark.parametrize("method", ["linear", "second_order", "drift_kick_drift"])
@pytest.mark.parametrize("tilt", [0.0, 0.1], ids=["untilted", "tilted"])
def test_dipole_tracks_like_jax(method, tilt):
    segment = ct.Segment([_dipole(method, tilt)])
    beam = _jax_beam(*_beam_arrays())
    expected = _jax_track(segment, beam)
    got = segment_to_torch(segment).track(beam_to_torch(beam))
    _assert_particles(got.particles, expected.particles)
    assert got.energy.item() == pytest.approx(float(expected.energy), rel=1e-15)


@pytest.mark.parametrize("fringe_at", ["neither", "entrance", "exit", "both"])
def test_dipole_fringes_like_jax(fringe_at):
    segment = ct.Segment([_dipole("drift_kick_drift", fringe_at=fringe_at)])
    beam = _jax_beam(*_beam_arrays(num_particles=500))
    _assert_particles(
        segment_to_torch(segment).track(beam_to_torch(beam)).particles,
        _jax_track(segment, beam).particles,
    )


@pytest.mark.parametrize("method", ["linear", "second_order"])
def test_sextupole_tracks_like_jax(method):
    sextupole = _element_pairs()["sextupole"]
    sextupole.tracking_method = method
    segment = ct.Segment([sextupole])
    beam = _jax_beam(*_beam_arrays())
    expected = _jax_track(segment, beam)
    port = segment_to_torch(segment)
    assert port.elements[0].tracking_method == method
    _assert_particles(port.track(beam_to_torch(beam)).particles, expected.particles)


def test_sextupole_defaults_to_second_order():
    sextupole = ctt.Sextupole(0.2, k2=60.0, dtype=F64, device=CPU)
    assert sextupole.tracking_method == "second_order" and not sextupole.is_skippable
    assert ctt.Sextupole.supported_tracking_methods == ct.Sextupole.supported_tracking_methods


# ---------------------------------------------------------------------------
# BASELINE config 3: the nonlinear chain
# ---------------------------------------------------------------------------


def _chain(voltage=2e7, phase=30.0, angle=0.15, k2=60.0):
    """BASELINE config 3 (``scripts/bench_all.py:379-410``) in float64."""
    kw = {"dtype": jnp.float64}
    return ct.Segment(
        [
            ct.Drift(jnp.asarray(0.2), **kw),
            ct.Cavity(
                jnp.asarray(1.0), voltage=jnp.asarray(voltage), phase=jnp.asarray(phase),
                frequency=jnp.asarray(1.3e9), name="cav", **kw,
            ),
            ct.Drift(jnp.asarray(0.2), **kw),
            ct.Dipole(
                jnp.asarray(0.4), angle=jnp.asarray(angle), tracking_method="drift_kick_drift",
                name="dip", **kw,
            ),
            ct.Drift(jnp.asarray(0.2), **kw),
            ct.Sextupole(jnp.asarray(0.2), k2=jnp.asarray(k2), name="sext", **kw),
            ct.Drift(jnp.asarray(0.2), **kw),
        ]
    )


def _astra_beam_arrays():
    """The ACHIP_EA1 ASTRA beam that BASELINE.md names for config 3 (the
    pickle ``tests/test_full_ares.py`` loads), read without the package that
    pickled it: its buffers are taken from the pickled module state."""

    class _State:
        def __setstate__(self, state):
            self.buffers = state["_buffers"]

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] == "cheetah":
                return _State
            return super().find_class(module, name)

    with open(ASTRA_BEAM, "rb") as handle:
        buffers = _Unpickler(handle).load().buffers
    return (
        buffers["particles"].double().numpy(),
        buffers["energy"].double().numpy(),
        buffers["particle_charges"].double().numpy(),
    )


def test_chain_plan_matches_jax():
    segment = _chain()
    jax_plan = [type(todo).__name__ for todo in segment._plan()]
    port_plan = segment_to_torch(segment)._plan()
    assert [type(todo).__name__ for todo in port_plan] == jax_plan
    assert jax_plan == ["Segment", "Cavity", "Segment", "Dipole", "_SecondOrderBracket"]
    bracket = port_plan[-1]
    assert [len(bracket.upstream), len(bracket.downstream)] == [1, 1]
    assert bracket.element.name == "sext"


def test_chain_tracks_astra_beam_like_jax():
    segment = _chain()
    beam = _jax_beam(*_astra_beam_arrays())
    expected = _jax_track(segment, beam)
    got = segment_to_torch(segment).track(beam_to_torch(beam))
    _assert_particles(got.particles, expected.particles)
    assert got.energy.item() == pytest.approx(float(expected.energy), rel=1e-15)
    assert got.s.item() == pytest.approx(2.4, rel=1e-15)
    assert got.sigma_x.item() == pytest.approx(float(expected.sigma_x), rel=1e-10)


def test_vectorised_chain_tracks_like_jax():
    """Two instances: voltages, phases and k2 of their own."""
    segment = _chain(voltage=np.array([2e7, 1.2e7]), phase=np.array([30.0, -10.0]),
                     k2=np.array([60.0, -25.0]))
    beam = _jax_beam(*_beam_arrays(num_particles=1000, seed=3))
    expected = _jax_track(segment, beam)
    got = segment_to_torch(segment).track(beam_to_torch(beam))
    assert tuple(got.particles.shape) == (2, 1000, 7)
    _assert_particles(got.particles, expected.particles)
    np.testing.assert_allclose(_np(got.energy), np.asarray(expected.energy), rtol=1e-15)


@pytest.mark.parametrize("beam_kind", ["particle", "parameter"])
def test_track_moments_through_bracket_matches_jax(beam_kind):
    """The Gaussian closure through the sextupole's bracket (after the
    cavity and the dkd dipole act on particles)."""
    segment = _chain()
    beam = _jax_beam(*_beam_arrays(num_particles=1000, seed=4))
    port_beam = beam_to_torch(beam)
    if beam_kind == "parameter":
        # A ParameterBeam cannot go through the dkd dipole; take the chain
        # from its second drift on.
        segment = ct.Segment(segment.elements[4:])
        beam = beam.as_parameter_beam()
        port_beam = port_beam.as_parameter_beam()
    expected = jax.jit(lambda s, b: s.track_moments(b))(segment, beam)
    got = segment_to_torch(segment).track_moments(port_beam)
    assert isinstance(got, ctt.ParameterBeam)
    # Moments of 1000 particles and a 7^4 closure: rtol 1e-9 of the largest
    # entry of each.
    for actual, want in ((got.mu, expected.mu), (got.cov, expected.cov)):
        np.testing.assert_allclose(
            _np(actual), np.asarray(want), rtol=0, atol=1e-9 * float(np.abs(want).max())
        )


# ---------------------------------------------------------------------------
# Drift-kick-drift against the Bmad-X ground truth
# ---------------------------------------------------------------------------


def _dkd_element(name: str, dtype):
    kw = {"dtype": dtype, "device": CPU, "tracking_method": "drift_kick_drift"}
    angle = 20 * math.pi / 180
    if name == "drift":
        return ctt.Drift(1.0, **kw)
    if name == "quadrupole":
        return ctt.Quadrupole(1.0, k1=10.0, misalignment=(0.01, -0.02), tilt=0.5, num_steps=10,
                              **kw)
    return ctt.Dipole(
        0.5, angle=angle, dipole_e1=angle / 2, dipole_e2=angle / 2, tilt=0.1,
        fringe_integral=0.5, fringe_integral_exit=0.5, gap=0.05, gap_exit=0.05,
        fringe_at="both", fringe_type="linear_edge", **kw,
    )


@pytest.mark.parametrize("name", ["drift", "quadrupole", "dipole"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_dkd_matches_bmadx_ground_truth(name, dtype):
    """The tolerances of ``tests/test_compare_bmadx_dkd.py:93-96``: exact in
    float64, atol 1e-5 / rtol 1e-6 in float32."""
    data = np.load(BMADX)
    incoming = ctt.ParticleBeam(
        torch.tensor(data["incoming_particles"], dtype=dtype),
        torch.tensor(data["incoming_energy"], dtype=dtype),
        particle_charges=torch.tensor(data["incoming_particle_charges"], dtype=dtype),
        species=ctt.Species(str(data["incoming_species"]), dtype=dtype, device=CPU),
    )
    outgoing = _dkd_element(name, dtype).track(incoming)
    expected = data[f"outgoing_{name}"].reshape(-1, 7)
    atol, rtol = (1e-14, 1e-14) if dtype == F64 else (1e-5, 1e-6)
    np.testing.assert_allclose(_np(outgoing.particles), expected, atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Gradients of the chain against jax.grad
# ---------------------------------------------------------------------------

# (element index, attribute, value): k2, the dipole's angle, the cavity's
# voltage and phase.
GRAD_CASES = {
    "k2": (5, "k2", 60.0),
    "angle": (3, "angle", 0.15),
    "voltage": (1, "voltage", 2e7),
    "phase": (1, "phase", 30.0),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_chain_gradient_of_sigma_x_matches_jax(case):
    index, attribute, value = GRAD_CASES[case]
    beam = _jax_beam(*_beam_arrays(num_particles=1000, seed=5))

    def jax_loss(v, segment):
        setattr(segment.elements[index], attribute, v)
        return segment.track(beam).sigma_x

    expected = float(jax.jit(jax.grad(jax_loss))(jnp.asarray(value), _chain()))
    port = segment_to_torch(_chain())
    v = torch.tensor(value, dtype=F64, requires_grad=True)
    setattr(port.elements[index], attribute, v)
    (actual,) = torch.autograd.grad(port.track(beam_to_torch(beam)).sigma_x, v)
    # The same chain rule through the same closed forms, summed over 1000
    # particles: rtol 1e-8.
    assert actual.item() == pytest.approx(expected, rel=1e-8)
    assert actual.item() != 0
