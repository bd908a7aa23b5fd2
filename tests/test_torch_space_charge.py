"""The space-charge slice of the PyTorch port against cheetah_tpu at float64:
the Drift-Kick-Drift-Kick-Drift segment of the space-charge benchmark at 2
instances, 2000 particles and an 8^3 grid. On the CPU the JAX package takes
its XLA two-hot deposit and gather (its Pallas kernels need a TPU); the port
takes the plain versions of its CUDA kernels.

The kicks (the change of px, py and p over the segment; the drifts leave
the momenta alone) are compared relative to their own size, so that an
error in the kick cannot hide behind the momenta it is added to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.ops import cic_kernels
from cheetah_tpu_torch.utils import profiling
from test_torch_tracking import beam_to_torch, segment_to_torch

GRID = (8, 8, 8)


def _jax_case(dtype=jnp.float64):
    a = lambda value: jnp.asarray(value, dtype)  # noqa: E731
    segment = ct.Segment(
        [
            ct.Drift(a(0.1)),
            ct.SpaceChargeKick(a([0.2, 0.5]), grid_shape=GRID),
            ct.Drift(a(0.1)),
            ct.SpaceChargeKick(a([0.2, 0.5]), grid_shape=GRID),
            ct.Drift(a(0.1)),
        ]
    )
    beam = ct.ParticleBeam.from_twiss(
        num_particles=2000,
        beta_x=a(5.0),
        alpha_x=a(-1.0),
        emittance_x=a(2e-9),
        beta_y=a(3.0),
        alpha_y=a(0.5),
        emittance_y=a(2e-9),
        sigma_tau=a(1e-5),
        sigma_p=a(1e-4),
        energy=a(1.54e8),
        total_charge=a(1e-9),
        key=jax.random.PRNGKey(3),
        dtype=dtype,
    )
    return segment, beam


def _kick_error(actual, expected, before, index):
    """Max deviation of the port's kick from the JAX kick, relative to the
    largest JAX kick in that coordinate."""
    kick_expected = np.asarray(expected.particles)[..., index] - before[..., index]
    kick_actual = actual.particles.numpy()[..., index] - before[..., index]
    size = np.abs(kick_expected).max()
    assert size > 0
    return np.abs(kick_actual - kick_expected).max() / size


def test_space_charge_segment_matches_jax():
    jax_segment, jax_beam = _jax_case()
    segment = segment_to_torch(jax_segment)
    beam = beam_to_torch(jax_beam)
    before = np.asarray(jax_beam.particles)

    expected = jax_segment.track(jax_beam)
    counted = profiling.counters()
    deposits, gathers = counted.get("deposit_multi_3d", 0), counted.get("gather_multi_3d", 0)
    actual = segment.track(beam)
    # CPU tensors run the plain versions and launch nothing.
    assert profiling.counters().get("deposit_multi_3d", 0) == deposits
    assert profiling.counters().get("gather_multi_3d", 0) == gathers

    assert actual.particles.shape == expected.particles.shape == (2, 2000, 7)
    # float64 on both sides; the packages differ only in summation order and
    # in the bin-space arithmetic of the deposit (3e-15 of the kick measured).
    for index, name in ((1, "px"), (3, "py")):
        assert _kick_error(actual, expected, before, index) < 1e-12, name
    # p goes through the SI round trip, whose gamma - gamma0 cancellation
    # costs eps * gamma0 / (beta0 gamma0) per particle (1e-13 measured).
    assert _kick_error(actual, expected, before, 5) < 1e-10, "p"
    for index in (0, 2, 4):
        scale = np.abs(before[..., index]).max()
        np.testing.assert_allclose(
            actual.particles.numpy()[..., index] / scale,
            np.asarray(expected.particles)[..., index] / scale,
            atol=1e-12,
        )


def test_integrated_green_function_matches_jax():
    jax_kick = ct.SpaceChargeKick(jnp.asarray(0.2), grid_shape=(4, 6, 5))
    kick = ctt.SpaceChargeKick(0.2, grid_shape=(4, 6, 5), dtype=torch.float64, device="cpu")
    gamma = np.array([301.4, 50.0])
    cell_size = np.array([[2e-5, 3e-5, 1e-6], [1e-4, 1e-4, 1e-4]])
    expected = jax_kick._integrated_green_function(jnp.asarray(gamma), jnp.asarray(cell_size))
    actual = kick._integrated_green_function(torch.from_numpy(gamma), torch.from_numpy(cell_size))
    assert actual.shape == (2, 8, 12, 10)
    scale = np.abs(np.asarray(expected)).max()
    np.testing.assert_allclose(actual.numpy() / scale, np.asarray(expected) / scale, atol=1e-12)


def test_bfloat16_beam_is_kicked_in_float32():
    kw = {"dtype": torch.float32, "device": "cpu"}
    kick = ctt.SpaceChargeKick(0.3, grid_shape=(6, 6, 6), **kw)
    generator = torch.Generator().manual_seed(0)
    beam = ctt.ParticleBeam.from_twiss(
        num_particles=1000, beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9,
        sigma_tau=1e-5, sigma_p=1e-4, total_charge=1e-9, generator=generator, **kw,
    )
    beam16 = beam.to(dtype=torch.bfloat16)
    out16 = kick.track(beam16)
    out32 = kick.track(beam16.to(dtype=torch.float32))
    assert out16.particles.dtype == torch.bfloat16
    assert torch.equal(out16.particles, out32.particles.to(torch.bfloat16))


def test_space_charge_float32_close_to_float64():
    """The port at float32 against itself at float64 on the CPU, as the card
    is checked. The RMS kick error stays within 1e-5 of the RMS kick in x and
    y (f32 deposit rounding plus grid edges that move with the f32 beam
    sizes; 8e-7 measured) and 2e-4 in p, where the f32 SI round trip adds
    eps * gamma0 / (beta0 gamma0) = 6e-8 per particle (4e-5 measured)."""
    jax_segment, jax_beam = _jax_case()
    segment = segment_to_torch(jax_segment)
    beam = beam_to_torch(jax_beam)
    before = beam.particles.numpy()
    expected = segment.track(beam)
    actual = segment.to(torch.float32).track(beam.to(dtype=torch.float32))
    for index, tolerance in ((1, 1e-5), (3, 1e-5), (5, 2e-4)):
        kick_expected = expected.particles.numpy()[..., index] - before[..., index]
        kick_actual = actual.particles.double().numpy()[..., index] - before[..., index]
        error = np.sqrt(np.mean((kick_actual - kick_expected) ** 2))
        assert error < tolerance * np.sqrt(np.mean(kick_expected**2)), index
