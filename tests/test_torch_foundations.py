"""Parity of the PyTorch port's foundations with cheetah_tpu at float64:
the maths helpers, the five linear transfer-map builders, the element maps,
the beam constructors, moments and SI conversions.

Inputs are made from a seed with numpy and given to both packages. Unless a
test says otherwise the tolerance is rtol 1e-12: both sides evaluate the
same formulas in float64, so they differ by a few ulps of libm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
from cheetah_tpu.ops import transfer_maps as jax_maps
from cheetah_tpu.utils import maths as jax_maths
from cheetah_tpu.utils import statistics as jax_statistics
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.ops import transfer_maps as torch_maps
from cheetah_tpu_torch.utils import maths as torch_maths
from cheetah_tpu_torch.utils import statistics as torch_statistics

CPU = "cpu"
F64 = torch.float64
RTOL = 1e-12


def _t(array) -> torch.Tensor:
    return torch.as_tensor(np.asarray(array), device=CPU)


def _close(actual: torch.Tensor, expected, rtol=RTOL, atol=0.0, err_msg=""):
    np.testing.assert_allclose(
        actual.numpy(), np.asarray(expected), rtol=rtol, atol=atol, err_msg=err_msg
    )


# Arguments at and around the removable singularity x = 0, on both branches.
MATHS_POINTS = np.array(
    [0.0, 1e-300, -1e-300, 1e-3, -1e-3, 0.3, -0.3, 2.0, -2.0, 25.0, -25.0, 400.0]
)


@pytest.mark.parametrize("name", ["cos_sqrt", "sinc_sqrt", "si1mdiv"])
def test_maths_values_at_and_near_zero(name):
    expected = getattr(jax_maths, name)(jnp.asarray(MATHS_POINTS))
    actual = getattr(torch_maths, name)(_t(MATHS_POINTS))
    # si1mdiv divides a difference of nearly equal numbers by x near 0; an
    # ulp of sin there is 1e-16 / 1e-3 relative, hence the absolute floor.
    _close(actual, expected, atol=1e-13 if name == "si1mdiv" else 0.0)
    assert actual[0].item() == {"cos_sqrt": 1.0, "sinc_sqrt": 1.0, "si1mdiv": 1 / 6}[name]


def _species_pair():
    return ct.Species("electron"), ctt.Species("electron", dtype=F64, device=CPU)


def test_species_constants_match():
    jax_species, torch_species = _species_pair()
    assert torch_species.mass_eV.item() == float(jax_species.mass_eV)
    assert torch_species.charge_coulomb.item() == float(jax_species.charge_coulomb)
    proton = ctt.Species("proton", dtype=F64, device=CPU)
    assert proton.mass_eV.item() == float(ct.Species("proton").mass_eV)


def test_base_rmatrix_matches():
    rng = np.random.default_rng(0)
    length = rng.uniform(0.05, 1.0, size=6)
    k1 = np.concatenate([[0.0, 1e-9], rng.uniform(-30, 30, size=4)])
    hx = np.array([0.0, 0.5, 0.0, -0.3, 0.2, 0.0])
    energy = rng.uniform(1e7, 1e9, size=6)
    jax_species, torch_species = _species_pair()
    expected = jax_maps.base_rmatrix(
        jnp.asarray(length), jnp.asarray(k1), jnp.asarray(hx), jax_species,
        jnp.asarray(energy),
    )
    actual = torch_maps.base_rmatrix(_t(length), _t(k1), _t(hx), torch_species, _t(energy))
    _close(actual, expected, atol=1e-15)


def test_drift_rotation_misalignment_builders_match():
    rng = np.random.default_rng(1)
    length = rng.uniform(0.0, 2.0, size=5)
    energy = rng.uniform(1e7, 1e9, size=5)
    angle = rng.uniform(-np.pi, np.pi, size=5)
    misalignment = rng.normal(scale=1e-3, size=(5, 2))
    jax_species, torch_species = _species_pair()

    _close(
        torch_maps.drift_matrix(_t(length), _t(energy), torch_species),
        jax_maps.drift_matrix(jnp.asarray(length), jnp.asarray(energy), jax_species),
    )
    _close(
        torch_maps.rotation_matrix(_t(angle)),
        jax_maps.rotation_matrix(jnp.asarray(angle)),
        atol=1e-16,
    )
    for actual, expected in zip(
        torch_maps.misalignment_matrix(_t(misalignment)),
        jax_maps.misalignment_matrix(jnp.asarray(misalignment)),
    ):
        _close(actual, expected)
    for actual, expected in zip(
        torch_maps.combined_rotation_misalignment_matrix(_t(angle), _t(misalignment)),
        jax_maps.combined_rotation_misalignment_matrix(
            jnp.asarray(angle), jnp.asarray(misalignment)
        ),
    ):
        _close(actual, expected, atol=1e-18)


def test_element_maps_match():
    rng = np.random.default_rng(2)
    energy = np.asarray(1.54e8)
    k1 = np.concatenate([[0.0], rng.uniform(-20, 20, size=3)])
    misalignment = rng.normal(scale=1e-4, size=2)
    tilt = np.asarray(0.1)
    pairs = [
        (
            ct.Quadrupole(jnp.asarray(0.122), k1=jnp.asarray(k1),
                          misalignment=jnp.asarray(misalignment), tilt=jnp.asarray(tilt)),
            ctt.Quadrupole(_t(0.122), k1=_t(k1), misalignment=_t(misalignment),
                           tilt=_t(tilt)),
        ),
        (ct.Drift(jnp.asarray(0.428)), ctt.Drift(_t(0.428))),
        (
            ct.HorizontalCorrector(jnp.asarray(0.02), angle=jnp.asarray([1e-4, -3e-4])),
            ctt.HorizontalCorrector(_t(0.02), angle=_t([1e-4, -3e-4])),
        ),
        (
            ct.VerticalCorrector(jnp.asarray(0.02), angle=jnp.asarray(2e-4)),
            ctt.VerticalCorrector(_t(0.02), angle=_t(2e-4)),
        ),
        (ct.Marker(), ctt.Marker(dtype=F64, device=CPU)),
    ]
    jax_species, torch_species = _species_pair()
    for jax_element, torch_element in pairs:
        expected = jax_element.first_order_transfer_map(jnp.asarray(energy), jax_species)
        actual = torch_element.first_order_transfer_map(_t(energy), torch_species)
        # Entries are O(1); products of the tilt rotation leave ~1e-17 residues
        # where the exact value is 0.
        _close(actual, expected, atol=1e-15, err_msg=type(torch_element).__name__)


def test_match_distribution_moments_matches():
    rng = np.random.default_rng(3)
    samples = rng.normal(size=(400, 6))
    mu = rng.normal(size=6)
    a = rng.normal(size=(6, 6))
    cov = a @ a.T + 6 * np.eye(6)
    weights = rng.uniform(0.5, 1.0, size=400)
    expected = jax_statistics.match_distribution_moments(
        jnp.asarray(samples), jnp.asarray(mu), jnp.asarray(cov), jnp.asarray(weights)
    )
    actual = torch_statistics.match_distribution_moments(
        _t(samples), _t(mu), _t(cov), _t(weights)
    )
    _close(actual, expected, atol=1e-12)
    # The moments are matched exactly.
    _close(
        torch_statistics.unbiased_weighted_covariance_matrix(actual, _t(weights)),
        cov,
        rtol=1e-12,
        atol=1e-12,
    )


TWISS = dict(
    beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9, beta_y=3.0, alpha_y=0.5,
    emittance_y=2e-9, sigma_tau=1e-5, sigma_p=1e-3, cov_taup=2e-9,
    dispersion_x=0.1, dispersion_px=0.01, energy=1.54e8, total_charge=1e-10,
)


def test_from_twiss_moments_match():
    """The samples differ between the packages, but moment matching is
    exact, so the beams' moments agree to float64 rounding (1e-10)."""
    import jax

    jax_beam = ct.ParticleBeam.from_twiss(
        num_particles=2000,
        key=jax.random.PRNGKey(0),
        dtype=jnp.float64,
        **{k: jnp.asarray(v, jnp.float64) for k, v in TWISS.items()},
    )
    generator = torch.Generator(device=CPU).manual_seed(0)
    torch_beam = ctt.ParticleBeam.from_twiss(
        num_particles=2000, generator=generator, dtype=F64, device=CPU, **TWISS
    )
    for name in ("sigma_x", "sigma_px", "sigma_y", "sigma_py", "sigma_tau", "sigma_p"):
        expected = float(getattr(jax_beam, name))
        assert getattr(torch_beam, name).item() == pytest.approx(expected, rel=1e-10), name
    for a, b in (("x", "px"), ("y", "py"), ("tau", "p"), ("x", "p")):
        expected = float(getattr(jax_beam, f"cov_{a}{b}"))
        actual = torch_statistics.unbiased_weighted_covariance(
            getattr(torch_beam, a), getattr(torch_beam, b), torch_beam.survival_probabilities
        )
        assert actual.item() == pytest.approx(expected, rel=1e-10), (a, b)
    for name in ("mu_x", "mu_px", "mu_y", "mu_py", "mu_tau", "mu_p"):
        scale = float(getattr(jax_beam, name.replace("mu", "sigma")))
        assert abs(getattr(torch_beam, name).item()) < 1e-10 * scale, name
        assert abs(float(getattr(jax_beam, name))) < 1e-10 * scale, name
    assert torch_beam.total_charge.item() == pytest.approx(1e-10, rel=1e-12)
    assert torch_beam.particles.dtype == F64
    assert torch.all(torch_beam.particles[..., 6] == 1)


def test_si_coordinates_and_relativistic_factors_match():
    rng = np.random.default_rng(4)
    particles = np.concatenate(
        [rng.normal(scale=[1e-4, 1e-5, 1e-4, 1e-5, 1e-5, 1e-3], size=(2, 300, 6)),
         np.ones((2, 300, 1))],
        axis=-1,
    )
    energy = np.array([1.54e8, 3e7])
    jax_beam = ct.ParticleBeam(jnp.asarray(particles), jnp.asarray(energy))
    torch_beam = ctt.ParticleBeam(_t(particles), _t(energy))
    _close(torch_beam.relativistic_gamma, jax_beam.relativistic_gamma)
    _close(torch_beam.relativistic_beta, jax_beam.relativistic_beta)

    xp_jax = jax_beam.to_xyz_pxpypz()
    xp_torch = torch_beam.to_xyz_pxpypz()
    _close(xp_torch, xp_jax, atol=1e-30)
    back_jax = ct.ParticleBeam.from_xyz_pxpypz(xp_jax, jnp.asarray(energy))
    back_torch = ctt.ParticleBeam.from_xyz_pxpypz(xp_torch, _t(energy))
    # The round trip recovers p through gamma - gamma0, which cancels to
    # about eps * gamma0 / (beta0 gamma0) absolute.
    _close(back_torch.particles, back_jax.particles, rtol=1e-10, atol=1e-14)
    _close(back_torch.particles, particles, rtol=1e-9, atol=1e-13)


def test_component_moments_match_weighted():
    rng = np.random.default_rng(5)
    particles = np.concatenate(
        [rng.normal(loc=1e-4, scale=1e-3, size=(3, 500, 6)), np.ones((3, 500, 1))],
        axis=-1,
    )
    survival = rng.uniform(0.2, 1.0, size=500)
    jax_beam = ct.ParticleBeam(
        jnp.asarray(particles), jnp.asarray(1e8),
        survival_probabilities=jnp.asarray(survival),
    )
    torch_beam = ctt.ParticleBeam(_t(particles), _t(1e8), survival_probabilities=_t(survival))
    for name in ("mu_x", "mu_py", "sigma_x", "sigma_px", "sigma_tau", "sigma_p"):
        _close(getattr(torch_beam, name), getattr(jax_beam, name), rtol=1e-11, err_msg=name)
