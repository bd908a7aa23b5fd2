"""ParameterBeam, the Twiss properties and ``Segment.track_moments`` of the
PyTorch port against cheetah_tpu.

Moments and Twiss functions come from the same named parameters in both
packages; beams and lattices cross over as numpy arrays
(``cheetah_tpu_torch.interop``). Everything runs in float64, where both
packages agree to rel 1e-10 (a 13-matrix product and the weighted
covariance over a few thousand particles round differently in the last
bits). ``track_moments`` also agrees with the port's own ``track`` to rel
1e-9: the moments of a linearly transported beam are an algebraic identity,
up to the raw-moment variance that ``track(...).sigma_x`` reads.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tracking import beam_to_torch, segment_to_torch

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch import interop

CPU = "cpu"
F64 = torch.float64
RTOL = 1e-10

TWISS_PROPERTIES = [
    "emittance_x", "normalized_emittance_x", "beta_x", "alpha_x", "projected_emittance_x",
    "emittance_y", "normalized_emittance_y", "beta_y", "alpha_y", "projected_emittance_y",
    "dispersion_x", "dispersion_px", "dispersion_y", "dispersion_py",
]
MOMENTS = [
    *(f"mu_{c}" for c in ("x", "px", "y", "py", "tau", "p")),
    *(f"sigma_{c}" for c in ("x", "px", "y", "py", "tau", "p")),
    *(f"cov_{pair}" for pair in ("xpx", "ypy", "taup", "xp", "pxp", "yp", "pyp", "xy")),
]

PARAMETER_SETS = {
    "defaults": {},
    "correlated": dict(
        mu_x=2e-5, mu_py=-1e-6, sigma_x=3e-4, sigma_px=2e-5, sigma_y=1e-4, sigma_py=4e-6,
        sigma_p=1e-3, cov_xpx=1e-9, cov_ypy=-1e-10, cov_xp=5e-8, cov_pxp=2e-9,
    ),
    "vector": dict(sigma_x=[1e-4, 2e-4, 3e-4], cov_xpx=[0.0, 1e-10, -1e-10], energy=[1e8, 1.5e8, 2e8]),
}


def parameter_beam_to_torch(beam, device=CPU) -> ctt.ParameterBeam:
    return interop.parameter_beam_from_numpy(
        np.asarray(beam.mu), np.asarray(beam.cov), np.asarray(beam.energy),
        np.asarray(beam.total_charge), np.asarray(beam.s), beam.species.name, device=device,
    )


def assert_close(actual, expected, rtol=RTOL, atol=0.0, err_msg=""):
    np.testing.assert_allclose(
        actual.detach().numpy(), np.asarray(expected), rtol=rtol, atol=atol, err_msg=err_msg
    )


def assert_moments_close(actual, expected_mu, expected_cov, rtol=RTOL):
    """Means and covariances, each entry relative to the beam's size:
    ``mu_i`` to ``sigma_i``, ``cov_ij`` to ``sigma_i sigma_j``, so that
    entries that cancel to rounding noise (cross-plane terms) compare on the
    scale they came from."""
    expected_mu = np.asarray(expected_mu)[..., :6]
    expected_cov = np.asarray(expected_cov)[..., :6, :6]
    sigma = np.sqrt(np.diagonal(expected_cov, axis1=-2, axis2=-1))
    np.testing.assert_allclose(
        actual.mu[..., :6].detach().numpy() / sigma, expected_mu / sigma, rtol=rtol, atol=rtol
    )
    scale = sigma[..., :, None] * sigma[..., None, :]
    np.testing.assert_allclose(
        actual.cov[..., :6, :6].detach().numpy() / scale, expected_cov / scale, rtol=rtol,
        atol=rtol,
    )
    np.testing.assert_allclose(actual.mu[..., 6].detach().numpy(), 1.0, rtol=1e-14)


@pytest.mark.parametrize("name", sorted(PARAMETER_SETS))
def test_from_parameters_moments_and_twiss(name):
    values = PARAMETER_SETS[name]
    beam = ctt.ParameterBeam.from_parameters(
        **{k: torch.tensor(v, dtype=F64) for k, v in values.items()}, dtype=F64, device=CPU
    )
    expected = ct.ParameterBeam.from_parameters(
        **{k: jnp.asarray(v, jnp.float64) for k, v in values.items()}, dtype=jnp.float64
    )
    assert_close(beam.mu, expected.mu)
    assert_close(beam.cov, expected.cov)
    assert_close(beam.energy, expected.energy)
    for prop in MOMENTS + TWISS_PROPERTIES:
        assert_close(getattr(beam, prop), getattr(expected, prop), atol=1e-30, err_msg=prop)


def test_from_twiss_matches():
    twiss = dict(beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9, beta_y=3.0, alpha_y=0.5,
                 emittance_y=2e-9, sigma_p=1e-3, dispersion_x=0.05, dispersion_py=1e-3,
                 energy=1.54e8, total_charge=1e-10)
    beam = ctt.ParameterBeam.from_twiss(**twiss, dtype=F64, device=CPU)
    expected = ct.ParameterBeam.from_twiss(
        **{k: jnp.asarray(v, jnp.float64) for k, v in twiss.items()}, dtype=jnp.float64
    )
    assert_close(beam.cov, expected.cov)
    for prop in ("beta_x", "alpha_x", "emittance_x", "beta_y", "alpha_y", "dispersion_x",
                 "dispersion_py", "normalized_emittance_y", "total_charge"):
        assert_close(getattr(beam, prop), getattr(expected, prop), err_msg=prop)
    # The Twiss functions come back from the moments.
    assert beam.beta_x.item() == pytest.approx(5.0, rel=1e-10)
    assert beam.alpha_y.item() == pytest.approx(0.5, rel=1e-10)


def test_non_positive_definite_raises():
    bad = dict(sigma_x=1e-4, sigma_px=1e-6, cov_xpx=1e-9)
    with pytest.raises(ValueError, match="positive definite"):
        ct.ParameterBeam.from_parameters(**{k: jnp.asarray(v) for k, v in bad.items()})
    with pytest.raises(ValueError, match="positive definite"):
        ctt.ParameterBeam.from_parameters(**bad, dtype=F64, device=CPU)
    ctt.ParameterBeam.from_parameters(**bad, dtype=F64, device=CPU, validate=False)
    with pytest.raises(ValueError, match="Beta function"):
        ctt.ParameterBeam.from_twiss(beta_x=-1.0, dtype=F64, device=CPU)


def jit_call(fn, *args):
    """``fn(*args)`` on the JAX side, compiled as one program (several
    times faster on the CPU than running it op by op)."""
    return jax.jit(fn)(*args)


def numpy_beam(num_particles, seed, sigmas, mu=(0.0,) * 6, correlation=0.5, weights=None):
    """A JAX ParticleBeam of Gaussian particles drawn with numpy: ``sigmas``
    and ``mu`` per coordinate, x-px and y-py correlated by
    ``correlation``, 100 pC in all, and optional survival weights."""
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(num_particles, 6))
    normal[:, 1] = correlation * normal[:, 0] + np.sqrt(1 - correlation**2) * normal[:, 1]
    normal[:, 3] = -correlation * normal[:, 2] + np.sqrt(1 - correlation**2) * normal[:, 3]
    particles = np.concatenate(
        [normal * np.asarray(sigmas) + np.asarray(mu), np.ones((num_particles, 1))], axis=1
    )
    return ct.ParticleBeam(
        jnp.asarray(particles), jnp.asarray(1.5e8),
        particle_charges=jnp.full((num_particles,), 1e-10 / num_particles),
        survival_probabilities=None if weights is None else jnp.asarray(weights),
    )


@functools.lru_cache
def _jax_beam(num_particles=3000, seed=3):
    return numpy_beam(num_particles, seed, (1.3e-4, 2.2e-5, 9e-5, 2.4e-5, 1e-6, 1e-6))


def _jax_ares(k1):
    segment = jax_ares_ea_subcell(dtype=jnp.float64)
    segment.AREAMQZM1.k1 = jnp.asarray(k1, jnp.float64)
    return segment


@pytest.mark.parametrize("k1", [10.0, [-20.0, -3.0, 0.0, 7.5, 20.0]], ids=["scalar", "vector"])
def test_parameter_beam_tracks_through_ares_ea(k1):
    jax_segment = _jax_ares(k1)
    jax_beam = ct.ParameterBeam.from_twiss(
        beta_x=jnp.asarray(5.0), emittance_x=jnp.asarray(2e-9), beta_y=jnp.asarray(3.0),
        emittance_y=jnp.asarray(2e-9), energy=jnp.asarray(1.54e8), dtype=jnp.float64,
    )
    expected = jit_call(lambda s, b: s.track(b), jax_segment, jax_beam)
    actual = segment_to_torch(jax_segment).track(parameter_beam_to_torch(jax_beam))
    assert isinstance(actual, ctt.ParameterBeam)
    assert_moments_close(actual, expected.mu, expected.cov)
    for prop in ("sigma_x", "sigma_y", "beta_x", "alpha_y", "emittance_x"):
        assert_close(getattr(actual, prop), getattr(expected, prop), err_msg=prop)
    assert actual.s.item() == pytest.approx(float(expected.s), rel=1e-12)


def _linear_segment():
    return ct.Segment(
        [
            ct.Drift(jnp.asarray(0.8), name="d1"),
            ct.Quadrupole(jnp.asarray(0.3), k1=jnp.asarray(6.0), name="q1"),
            ct.Drift(jnp.asarray(0.5), name="d2"),
            ct.HorizontalCorrector(jnp.asarray(0.1), angle=jnp.asarray(2e-4), name="hc"),
            ct.Quadrupole(jnp.asarray(0.3), k1=jnp.asarray(-5.0), name="q2"),
            ct.Drift(jnp.asarray(1.2), name="d3"),
        ],
        name="linear",
    )


def _apertured_segment():
    return ct.Segment(
        [
            ct.Drift(jnp.asarray(0.5), name="d1"),
            ct.Aperture(x_max=jnp.asarray(2e-4), y_max=jnp.asarray(2e-4), shape="rectangular",
                        is_active=True, name="ap"),
            ct.Drift(jnp.asarray(0.5), name="d2"),
            ct.Quadrupole(jnp.asarray(0.2), k1=jnp.asarray(3.0), name="q1"),
        ],
        name="apertured",
    )


def _batched_segment():
    segment = _linear_segment()
    segment.q1.k1 = jnp.linspace(-12.0, 12.0, 8, dtype=jnp.float64)
    return segment


SEGMENTS = {
    "linear": _linear_segment,
    "apertured": _apertured_segment,
    "batched": _batched_segment,
    "ares_ea_vector_k1": lambda: _jax_ares(jnp.linspace(-20, 20, 6)),
    "empty": lambda: ct.Segment([], name="empty"),
}


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_track_moments_matches(name):
    jax_segment, jax_beam = SEGMENTS[name](), _jax_beam()
    segment, beam = segment_to_torch(jax_segment), beam_to_torch(jax_beam)
    expected = jit_call(lambda s, b: s.track_moments(b), jax_segment, jax_beam)
    moments = segment.track_moments(beam)
    assert isinstance(moments, ctt.ParameterBeam)
    assert_moments_close(moments, expected.mu, expected.cov)
    # The same moments as tracking the particles and reading them out.
    tracked = segment.track(beam)
    for prop in ("sigma_x", "sigma_y", "mu_x", "mu_y"):
        scale = tracked.sigma_x if prop.startswith("mu") else 1.0
        assert_close(getattr(moments, prop) / scale, getattr(tracked, prop) / scale,
                     rtol=1e-9, atol=1e-9, err_msg=prop)
    parameters = tracked.as_parameter_beam()
    assert_moments_close(moments, parameters.mu, parameters.cov, rtol=1e-9)


def test_track_moments_of_a_parameter_beam_is_track():
    jax_segment = _linear_segment()
    segment = segment_to_torch(jax_segment)
    beam = beam_to_torch(_jax_beam()).as_parameter_beam()
    moments = segment.track_moments(beam)
    tracked = segment.track(beam)
    assert torch.equal(moments.mu, tracked.mu) and torch.equal(moments.cov, tracked.cov)


def test_track_moments_gradient_matches_track():
    segment, beam = segment_to_torch(_linear_segment()), beam_to_torch(_jax_beam())
    k1 = torch.tensor(6.0, dtype=F64, requires_grad=True)
    segment.q1.k1 = k1
    (grad_moments,) = torch.autograd.grad(segment.track_moments(beam).sigma_x, k1)
    (grad_particles,) = torch.autograd.grad(segment.track(beam).sigma_x, k1)
    assert torch.isfinite(grad_moments)
    assert grad_moments.item() == pytest.approx(grad_particles.item(), rel=1e-8)


def test_track_moments_refuses_second_order_closure():
    """The Gaussian closure is ported: track_moments no longer refuses a
    second_order element; it equals tracking the collapsed ParameterBeam,
    and "particles" equals the tracked particles' moments."""
    segment = ctt.Segment(
        [ctt.Quadrupole(0.2, k1=3.0, tracking_method="second_order", dtype=F64, device=CPU)]
    )
    beam = ctt.ParticleBeam.from_twiss(num_particles=100, generator=torch.Generator(),
                                       dtype=F64, device=CPU)
    closure = segment.track_moments(beam)
    expected = segment.track(beam.as_parameter_beam())
    assert isinstance(closure, ctt.ParameterBeam)
    np.testing.assert_allclose(closure.cov.numpy(), expected.cov.numpy(), rtol=1e-14, atol=0)
    particles = segment.track_moments(beam, second_order="particles")
    np.testing.assert_allclose(
        particles.cov.numpy(), segment.track(beam).as_parameter_beam().cov.numpy(), rtol=1e-12
    )


def test_space_charge_kick_refuses_parameter_beam():
    kick = ctt.SpaceChargeKick(0.1, dtype=F64, device=CPU)
    with pytest.raises(TypeError, match="ParticleBeam"):
        kick.track(ctt.ParameterBeam.from_parameters(dtype=F64, device=CPU))


@functools.lru_cache
def _jax_survival_beam():
    weights = np.random.default_rng(9).uniform(size=2000)
    return numpy_beam(2000, 5, (1.3e-4, 2.2e-5, 9e-5, 2.4e-5, 1e-6, 1e-3),
                      mu=(2e-5, 0.0, -1e-5, 1e-6, 0.0, 1e-4), weights=weights)


def test_particle_beam_moments_and_as_parameter_beam():
    jax_beam = _jax_survival_beam()
    beam = beam_to_torch(jax_beam)
    for prop in MOMENTS + TWISS_PROPERTIES + ["num_particles_survived", "total_charge"]:
        assert_close(getattr(beam, prop), getattr(jax_beam, prop), rtol=1e-9, atol=1e-30,
                     err_msg=prop)
    parameters, expected = beam.as_parameter_beam(), jax_beam.as_parameter_beam()
    assert_moments_close(parameters, expected.mu, expected.cov)
    assert_close(parameters.total_charge, expected.total_charge)


@pytest.mark.parametrize("kind", ["particle", "parameter"])
def test_transformed_to(kind):
    jax_beam = _jax_survival_beam()
    # Sizes only grow, so that the parameter beam's covariance stays
    # positive definite with its other entries kept.
    changes = dict(mu_x=1e-4, sigma_x=5e-4, sigma_py=5e-5, energy=2e8, total_charge=5e-11)
    if kind == "parameter":
        jax_beam = jax_beam.as_parameter_beam()
        beam = parameter_beam_to_torch(jax_beam)
        changes["cov_xpx"] = 0.0
    else:
        beam = beam_to_torch(jax_beam)
    expected = jit_call(lambda b: b.transformed_to(**{k: jnp.asarray(v) for k, v in changes.items()}),
                        jax_beam)
    actual = beam.transformed_to(**changes)
    for prop in ("mu_x", "mu_y", "sigma_x", "sigma_px", "sigma_py", "energy", "total_charge",
                 "cov_xpx"):
        assert_close(getattr(actual, prop), getattr(expected, prop), rtol=1e-9, atol=1e-30,
                     err_msg=prop)


def test_linspaced_and_make_linspaced():
    jax_beam = _jax_survival_beam()
    beam = beam_to_torch(jax_beam)
    assert_close(beam.linspaced(11).particles, jax_beam.linspaced(11).particles, atol=1e-24)
    parameters = jax_beam.as_parameter_beam()
    assert_close(parameter_beam_to_torch(parameters).linspaced(7).particles,
                 parameters.linspaced(7).particles, atol=1e-24)
    assert_close(
        ctt.ParticleBeam.make_linspaced(num_particles=5, mu_x=1e-4, sigma_p=1e-3, dtype=F64,
                                        device=CPU).particles,
        ct.ParticleBeam.make_linspaced(num_particles=5, mu_x=jnp.asarray(1e-4),
                                       sigma_p=jnp.asarray(1e-3), dtype=jnp.float64).particles,
        atol=0,
    )


def test_as_particle_beam_and_clone():
    beam = ctt.ParameterBeam.from_parameters(
        **{k: torch.tensor(v, dtype=F64) for k, v in PARAMETER_SETS["correlated"].items()},
        total_charge=1e-10, device=CPU,
    )
    particles = beam.as_particle_beam(5000, generator=torch.Generator().manual_seed(1))
    assert particles.num_particles == 5000 and particles.particles.dtype == F64
    # The sample's moments are matched exactly (whitened and recoloured).
    assert_moments_close(particles.as_parameter_beam(), beam.mu, beam.cov, rtol=1e-9)
    assert particles.total_charge.item() == pytest.approx(1e-10, rel=1e-12)
    copy = beam.clone()
    assert torch.equal(copy.cov, beam.cov) and copy.cov is not beam.cov
    assert copy.species == beam.species
    assert beam.defining_features == ["mu", "cov", "energy", "total_charge", "s", "species"]
