"""``csrc/fused_transport.cu`` on a card: the kernel against its plain
version, and the paths that take it or bypass it.

The outgoing particles and the weighted sums against the plain version
of the same inputs in float64 (within 1e-6 of the largest value in
float32, 1e-13 in float64) at the env step's shape (4096 instances sharing
10000 particles), with dead particles, on per-instance beams of 1001
particles, one particle, one instance of 1000003 particles (chunks and
the sums pass) and a beam that is not 16-byte aligned; the same bits on
two runs; the env step counting one launch and no matmul or moment pass,
and the moments and gradient steps none.

Every test here is marked ``card`` and skips without a CUDA device. On the
card, with no JAX installed: ``python -m pytest
tests/test_torch_fused_transport_card.py -m card --noconftest``. This file
imports no JAX.
"""

import pytest
import torch

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.ops import fused_transport
from cheetah_tpu_torch.parallel import BatchedLatticeEnv
from cheetah_tpu_torch.particles.particle_beam import _weighted_moments, _weighted_sums
from cheetah_tpu_torch.utils import profiling

pytestmark = pytest.mark.card

F32, F64 = torch.float32, torch.float64
#: The kernel against the plain version in float64: the largest difference
#: over the largest value, of the particles and of each sum.
TOLERANCE = {F32: 1e-6, F64: 1e-13}
COUNTERS = ("fused_transport", "fused_transport_matmul", "moments_reduction")
TUNABLES = [("AREAMQZM1", "k1"), ("AREAMQZM2", "k1"), ("AREAMQZM3", "k1"),
            ("AREAMCVM1", "angle"), ("AREAMCHM1", "angle")]
CASES = ("env", "env_dead_particles", "per_instance_1001", "one_particle", "one_instance_1000003",
         "not_aligned")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_fused_transport_card.py -m card --noconftest)")
    return "cuda"


def _inputs(case, dtype, device, seed=1):
    generator = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=device, dtype=F64).to(dtype)

    def particles(*shape):
        values = (rand(*shape) - 0.5) * 2e-4
        values[..., 6] = 1.0
        return values

    maps = rand(4096, 7, 7) * 2 - 1
    if case == "env":
        return particles(10_000, 7), maps, torch.ones(10_000, dtype=dtype, device=device)
    if case == "env_dead_particles":
        return particles(10_000, 7), maps, rand(10_000) * (rand(10_000) > 0.3)
    if case == "per_instance_1001":
        return particles(3, 1001, 7), maps[:3], rand(3, 1001)
    if case == "one_particle":
        return particles(1, 7), maps[:5], rand(1)
    if case == "one_instance_1000003":
        return particles(1_000_003, 7), maps[0], rand(1_000_003)
    return particles(2, 10, 7)[:, 1:], maps[:2], rand(2, 9)


def _counted(fn):
    before = profiling.counters()
    out = fn()
    torch.cuda.synchronize()
    after = profiling.counters()
    return out, tuple(after.get(name, 0) - before.get(name, 0) for name in COUNTERS)


def _share(actual, expected):
    return ((actual.double() - expected).abs().max() / expected.abs().max()).item()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_card_kernel_matches_the_plain_version(card, dtype, case):
    particles, transfer_map, weights = _inputs(case, dtype, card)
    got, moved = _counted(lambda: fused_transport.TRANSPORT_MOMENTS(particles, transfer_map,
                                                                     weights))
    assert moved == (1, 0, 0)
    out = torch.matmul(particles.double(), transfer_map.double().transpose(-1, -2))
    expected = (out, *_weighted_sums(out, weights.double()))
    for actual, want in zip(got, expected):
        assert actual.shape == want.shape and actual.dtype == dtype and actual.is_contiguous()
        assert bool(torch.isfinite(actual).all())
        assert _share(actual, want) <= TOLERANCE[dtype]


@pytest.mark.parametrize("case", ["env", "one_instance_1000003"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_card_kernel_gives_the_same_bits_on_every_run(card, dtype, case):
    particles, transfer_map, weights = _inputs(case, dtype, card)
    first = fused_transport.TRANSPORT_MOMENTS(particles, transfer_map, weights)
    for _ in range(2):
        again = fused_transport.TRANSPORT_MOMENTS(particles, transfer_map, weights)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _env(dtype, device, moments_only=False, instances=4096):
    segment = ctt.lattices.ares_ea_subcell(dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(4)
    if moments_only:
        beam = ctt.ParameterBeam.from_twiss(beta_x=5.0, emittance_x=2e-9, beta_y=3.0,
                                            emittance_y=2e-9, energy=1.54e8, dtype=dtype,
                                            device=device)
    else:
        beam = ctt.ParticleBeam.from_twiss(num_particles=10_000, beta_x=5.0, emittance_x=2e-9,
                                           beta_y=3.0, emittance_y=2e-9, energy=1.54e8,
                                           dtype=dtype, device=device, generator=generator)
    settings = torch.rand(instances, 5, generator=generator, device=device, dtype=F64) * 2 - 1
    settings[:, :3] *= 20
    settings[:, 3:] *= 1e-3
    env = BatchedLatticeEnv(segment, beam, TUNABLES, moments_only=moments_only)
    return env, settings.to(dtype)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_card_env_step_launches_once_and_reads_no_particle_again(card, dtype):
    """One launch, no matmul and no pass of the readout over the particles;
    the reward within the kernel's tolerance of the plain moments of the
    same outgoing particles."""
    env, settings = _env(dtype, card)
    (outgoing, _, reward), moved = _counted(lambda: env.step(settings))
    assert moved == (1, 0, 0)
    variance = _weighted_moments(outgoing.particles.double(),
                                 outgoing.survival_probabilities.double())[1]
    expected = -torch.hypot(torch.sqrt(variance[..., 0]), torch.sqrt(variance[..., 2]))
    assert _share(reward, expected) <= 10 * TOLERANCE[dtype]


def test_card_moments_and_gradient_steps_bypass_the_kernel(card):
    """The ParameterBeam's step transports no particle; the gradient step
    keeps the matmul, counted once a step."""
    env, settings = _env(F32, card, moments_only=True)
    _, moved = _counted(lambda: env.step(settings))
    assert moved == (0, 0, 0)
    env, settings = _env(F32, card, instances=256)
    _, moved = _counted(lambda: env.grad_step(settings, 1e4))
    assert moved[:2] == (0, 1)
