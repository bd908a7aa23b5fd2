"""A particle beam through its 7x7 map and the moment sums of the outgoing
beam in one operator call (``cheetah_tpu_torch/ops/fused_transport.py``,
``csrc/fused_transport.cu``), on the CPU.

The operator's plain version equals ``torch.matmul`` and the beam's own
moments bit for bit on shared, per-instance and single beams, weights per
particle or per instance, dead particles, one particle and particle counts
off the kernel's groups; the ARES EA run through it agrees with the JAX
package in float64; the dispatch leaves every transport that tracks a
gradient, or mixes dtypes, on the matmul (``fused_transport_matmul``);
the env step reads its moments from the sums the operator returned
(``moments_reduction`` stays put), and an in-place edit of the outgoing
beam drops them; the fake rule's shapes; the card path's strides, chunks
and pointers, run against an emulation of the kernel; and a compiled env
step holds the operator once and does not trace again.

The kernel itself is held to the plain version on a card by
``test_torch_fused_transport_card.py``.
"""

import collections
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functorch.compile import make_boxed_func
from torch._dynamo.backends.common import aot_autograd
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.autograd import forward_ad

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.ops import fused_transport
from cheetah_tpu_torch.parallel import BatchedLatticeEnv
from cheetah_tpu_torch.particles.particle_beam import _finish_moments, _weighted_moments
from cheetah_tpu_torch.utils import profiling
from test_torch_tracking import beam_to_torch, segment_to_torch

CPU = "cpu"
F32, F64 = torch.float32, torch.float64
OPERATOR = "cheetah_tpu_torch.transport_moments.default"
COUNTERS = ("fused_transport", "fused_transport_matmul", "moments_reduction")
TUNABLES = [("AREAMQZM1", "k1"), ("AREAMQZM2", "k1"), ("AREAMQZM3", "k1"),
            ("AREAMCVM1", "angle"), ("AREAMCHM1", "angle")]


def _counted(fn):
    """``fn()`` and how far it moved each of :data:`COUNTERS`."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, tuple(after.get(name, 0) - before.get(name, 0) for name in COUNTERS)


def _inputs(case, dtype, seed=0):
    """Particles, map and weights of a case: the particles on the scale of
    a beam (1e-4) with the constant 1 in the last column."""
    generator = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=generator, dtype=F64).to(dtype)

    def particles(*shape):
        values = (rand(*shape) - 0.5) * 2e-4
        values[..., 6] = 1.0
        return values

    maps = rand(5, 7, 7) * 2 - 1
    cases = {
        "shared_beam_batched_map": (particles(203, 7), maps, rand(203)),
        "batched_beam_batched_map": (particles(5, 203, 7), maps, rand(203)),
        "single_beam_single_map": (particles(203, 7), maps[0], rand(203)),
        "weights_per_instance": (particles(203, 7), maps, rand(5, 203)),
        "dead_particles": (particles(5, 203, 7), maps, rand(5, 203) * (rand(5, 203) > 0.4)),
        "one_particle": (particles(1, 7), maps, rand(1)),
        "particles_off_the_groups": (particles(1001, 7), maps[:2], rand(1001)),
    }
    return cases[case]


CASES = ("shared_beam_batched_map", "batched_beam_batched_map", "single_beam_single_map",
         "weights_per_instance", "dead_particles", "one_particle", "particles_off_the_groups")


# ---------------------------------------------------------------------------
# The plain version and the readout's formula
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_plain_version_equals_the_matmul_and_the_beams_moments(dtype, case):
    """The outgoing particles are ``torch.matmul``'s, and the moments
    finished from the operator's sums are ``_weighted_moments`` of them,
    bit for bit."""
    particles, transfer_map, weights = _inputs(case, dtype)
    out, s1, s2 = fused_transport.TRANSPORT_MOMENTS(particles, transfer_map, weights)
    expected = torch.matmul(particles, transfer_map.transpose(-1, -2))
    assert out.shape == expected.shape and out.is_contiguous()
    assert torch.equal(out, expected)
    assert s1.shape == s2.shape == (*expected.shape[:-2], 7)
    mean, variance = _finish_moments(s1, s2, weights)
    expected_mean, expected_variance = _weighted_moments(expected, weights)
    # One particle's unbiased variance is 0 / 0 both ways.
    for got, want in ((mean, expected_mean), (variance, expected_variance)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_plain_version_counts_each_call():
    particles, transfer_map, weights = _inputs("shared_beam_batched_map", F64)
    _, moved = _counted(lambda: fused_transport.TRANSPORT_MOMENTS(particles, transfer_map,
                                                                   weights))
    assert moved == (1, 0, 0)


@pytest.mark.parametrize("shapes", [
    ((10, 7), (3, 7, 7), (4, 10)),
    ((10, 7), (3, 7, 7), (11,)),
    ((10, 6), (3, 7, 7), (10,)),
    ((10, 7), (3, 6, 7), (10,)),
], ids=["weights_outside_the_beam", "other_particle_count", "six_columns", "map_not_7x7"])
def test_inputs_that_make_no_beam_raise_and_are_not_taken(shapes):
    particles, transfer_map, weights = (torch.zeros(shape, dtype=F64) for shape in shapes)
    assert not fused_transport.takes(particles, transfer_map, weights)
    with pytest.raises(ValueError, match="do not make one beam"):
        fused_transport.TRANSPORT_MOMENTS(particles, transfer_map, weights)


def test_fake_rule_gives_the_plain_versions_shapes():
    particles, transfer_map, weights = _inputs("weights_per_instance", F32)
    expected = fused_transport.TRANSPORT_MOMENTS(particles, transfer_map, weights)
    with FakeTensorMode() as mode:
        fake = fused_transport.TRANSPORT_MOMENTS(*(mode.from_tensor(tensor) for tensor in (
            particles, transfer_map, weights)))
    for got, want in zip(fake, expected):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.stride() == want.stride()


def test_flop_formula_counts_the_transports_product():
    """The operator counts the FLOPs of the matmul it replaces, and none for
    the sums it takes in the same pass."""
    particles, transfer_map, weights = _inputs("shared_beam_batched_map", F64)
    counter = torch.utils.flop_counter.FlopCounterMode(display=False)
    with counter:
        fused_transport.TRANSPORT_MOMENTS(particles, transfer_map, weights)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as plain:
        torch.matmul(particles, transfer_map.transpose(-1, -2))
    assert counter.get_total_flops() == plain.get_total_flops() == 2 * 5 * 203 * 7 * 7


# ---------------------------------------------------------------------------
# The ARES run against the JAX package
# ---------------------------------------------------------------------------


def test_ares_env_step_through_the_operator_matches_jax_in_float64():
    """The ARES EA subcell at three instances, float64: the port's particles
    (one ``transport_moments``) and its moments from the operator's sums
    against the JAX package's ``segment.track``."""
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64)
    jax_segment.AREAMQZM1.k1 = jnp.linspace(-20, 20, 3, dtype=jnp.float64)
    jax_segment.AREAMCHM1.angle = a([-1e-3, 0.0, 5e-4])
    jax_beam = ct.ParticleBeam.from_twiss(
        num_particles=1001, beta_x=a(5.0), alpha_x=a(-1.0), emittance_x=a(2e-9),
        beta_y=a(3.0), alpha_y=a(0.5), emittance_y=a(2e-9), energy=a(1.54e8),
        total_charge=a(1e-10), key=jax.random.PRNGKey(11), dtype=jnp.float64,
    )
    segment, beam = segment_to_torch(jax_segment), beam_to_torch(jax_beam)
    expected = jax_segment.track(jax_beam)
    names = ("sigma_x", "sigma_y", "sigma_px", "sigma_py", "mu_x", "mu_y")
    (actual, moments), moved = _counted(lambda: (lambda out: (out, {
        name: getattr(out, name) for name in names}))(segment.track(beam)))
    assert moved == (1, 0, 0)
    scale = np.abs(np.asarray(expected.particles)).max(axis=(0, 1))
    np.testing.assert_allclose(actual.particles.numpy() / scale,
                               np.asarray(expected.particles) / scale, rtol=1e-10, atol=1e-10)
    for name in names:
        sigma = np.asarray(getattr(expected, name.replace("mu", "sigma")))
        np.testing.assert_allclose(moments[name].numpy() / sigma,
                                   np.asarray(getattr(expected, name)) / sigma,
                                   rtol=1e-10, atol=1e-10, err_msg=name)


# ---------------------------------------------------------------------------
# The dispatch and the moment memo
# ---------------------------------------------------------------------------


def _env(dtype=F64, num_particles=211, seed=3):
    beam = ctt.ParticleBeam.from_twiss(
        num_particles=num_particles, beta_x=5.0, emittance_x=2e-9, beta_y=3.0,
        emittance_y=2e-9, energy=1.54e8, dtype=dtype, device=CPU,
        generator=torch.Generator().manual_seed(seed),
    )
    return BatchedLatticeEnv(ctt.lattices.ares_ea_subcell(dtype, device=CPU), beam, TUNABLES)


def _settings(instances, dtype, seed):
    generator = torch.Generator().manual_seed(seed)
    settings = torch.rand(instances, 5, generator=generator, dtype=F64) * 2 - 1
    settings[:, :3] *= 20
    settings[:, 3:] *= 1e-3
    return settings.to(dtype)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_env_step_reads_its_moments_from_the_operators_sums(dtype):
    """One ``transport_moments`` a step and no pass of the readout over the
    particles; the reward equals the one computed from the particles."""
    env = _env(dtype)
    settings = _settings(6, dtype, 1)
    (outgoing, _, reward), moved = _counted(lambda: env.step(settings))
    assert moved == (1, 0, 0)
    mean, variance = _weighted_moments(outgoing.particles, outgoing.survival_probabilities)
    assert torch.equal(reward, -torch.hypot(torch.sqrt(variance[..., 0]),
                                            torch.sqrt(variance[..., 2])))
    assert torch.equal(outgoing.mu_x, mean[..., 0])
    _, moved = _counted(lambda: (outgoing.sigma_py, outgoing.mu_tau))
    assert moved == (0, 0, 0)


def test_an_in_place_edit_drops_the_seeded_sums():
    """An in-place edit of the outgoing particles or weights bumps their
    version: the next read sums the particles again and gives the edited
    beam's moments."""
    env = _env()
    outgoing = env.step(_settings(4, F64, 2))[0]
    before = outgoing.sigma_x
    outgoing.particles[..., 0].mul_(2.0)
    sigma_x, moved = _counted(lambda: outgoing.sigma_x)
    assert moved == (0, 0, 1)
    torch.testing.assert_close(sigma_x, 2 * before, rtol=1e-12, atol=0)
    assert torch.equal(sigma_x, torch.sqrt(_weighted_moments(
        outgoing.particles, outgoing.survival_probabilities)[1][..., 0]))
    outgoing = env.step(_settings(4, F64, 2))[0]
    outgoing.survival_probabilities[::2] = 0.0
    _, moved = _counted(lambda: outgoing.sigma_y)
    assert moved == (0, 0, 1)


def _k1_requires_grad(segment, beam):
    segment.AREAMQZM1.k1 = torch.linspace(-5, 5, 3, dtype=F64).requires_grad_()
    return segment.track(beam).sigma_x


def _particles_require_grad(segment, beam):
    beam.particles = beam.particles.clone().requires_grad_()
    return segment.track(beam).sigma_x


def _weights_require_grad(segment, beam):
    beam.survival_probabilities = beam.survival_probabilities.clone().requires_grad_()
    return segment.track(beam).sigma_x


def _func_grad(segment, beam):
    def sigma(k1):
        segment.AREAMQZM1.k1 = k1
        return segment.track(beam).sigma_x.sum()

    return torch.func.grad(sigma)(torch.tensor(3.0, dtype=F64))


def _forward_ad(segment, beam):
    with forward_ad.dual_level():
        segment.AREAMQZM1.k1 = forward_ad.make_dual(torch.tensor(3.0, dtype=F64),
                                                    torch.tensor(1.0, dtype=F64))
        return forward_ad.unpack_dual(segment.track(beam).sigma_x).tangent


def _mixed_dtypes(segment, beam):
    beam.survival_probabilities = beam.survival_probabilities.to(F32)
    return segment.track(beam).particles


@pytest.mark.parametrize("tracking", [_k1_requires_grad, _particles_require_grad,
                                      _weights_require_grad, _func_grad, _forward_ad,
                                      _mixed_dtypes],
                         ids=["k1_requires_grad", "particles_require_grad",
                              "weights_require_grad", "func_grad", "forward_ad", "mixed_dtypes"])
def test_a_tracked_gradient_or_mixed_dtypes_take_the_matmul(tracking):
    """No ``transport_moments`` where a gradient is tracked, under a
    ``torch.func`` transform or a forward-mode level, or where the
    weights' dtype is not the particles': the matmul, counted."""
    segment = ctt.lattices.ares_ea_subcell(F64, device=CPU)
    beam = _env(F64).incoming
    out, moved = _counted(lambda: tracking(segment, beam))
    assert moved[:2] == (0, 1)
    assert torch.isfinite(out).all()


def test_a_gradient_through_the_matmul_is_the_one_before():
    """The gradient path's value and derivative equal those of the matmul
    and the plain moments, computed by hand."""
    segment = ctt.lattices.ares_ea_subcell(F64, device=CPU)
    beam = _env(F64).incoming
    k1 = torch.linspace(-5, 5, 3, dtype=F64).requires_grad_()
    segment.AREAMQZM1.k1 = k1
    sigma = segment.track(beam).sigma_x
    (grad,) = torch.autograd.grad(sigma.sum(), k1)
    tm = segment.first_order_transfer_map(beam.energy, beam.species)
    particles = torch.matmul(beam.particles, tm.transpose(-1, -2))
    expected = torch.sqrt(_weighted_moments(particles, beam.survival_probabilities)[1][..., 0])
    (expected_grad,) = torch.autograd.grad(expected.sum(), k1)
    assert torch.equal(sigma, expected) and torch.equal(grad, expected_grad)


def test_the_parameter_beam_takes_no_transport():
    """A ParameterBeam's congruence neither launches nor counts a particle
    transport."""
    segment = ctt.lattices.ares_ea_subcell(F64, device=CPU)
    beam = ctt.ParameterBeam.from_twiss(beta_x=5.0, emittance_x=2e-9, beta_y=3.0,
                                        emittance_y=2e-9, energy=1.54e8, dtype=F64, device=CPU)
    _, moved = _counted(lambda: segment.track(beam).sigma_x)
    assert moved == (0, 0, 0)


# ---------------------------------------------------------------------------
# The card path against an emulation of the kernel
# ---------------------------------------------------------------------------


def _read(address, count, dtype):
    scalar = ctypes.c_float if dtype == F32 else ctypes.c_double
    return torch.from_numpy(np.ctypeslib.as_array((scalar * count).from_address(address)).copy())


def _emulated_launch(calls):
    """``LIBRARY.launch`` replaced by a reading of what the kernel reads:
    each instance's ``(n, 7)`` particles, ``(7, 7)`` map and ``n`` weights at
    their addresses and strides; the outgoing particles and the sums
    (float64, rounded to the dtype) written to ``out``, ``s1`` and ``s2``;
    a partial-sums buffer exactly where an instance spans several
    chunks."""

    def launch(name, dtype, device, particles, particle_stride, maps, map_stride, weights,
               weight_stride, n, instances, chunk, out, s1, s2, partials):
        assert name == "transport_moments" and device.type == CPU
        tile = fused_transport.THREADS * (16 // dtype.itemsize)
        assert chunk % tile == 0 and chunk >= tile
        assert (partials is not None) == (n > chunk)
        size = dtype.itemsize
        outgoing, sums = [], []
        for b in range(instances):
            p = _read(particles + size * b * particle_stride, n * 7, dtype).reshape(n, 7)
            m = _read(maps + size * b * map_stride, 49, dtype).reshape(7, 7)
            w = _read(weights + size * b * weight_stride, n, dtype)
            o = p @ m.T
            outgoing.append(o)
            sums.append(torch.stack([w.double() @ o.double(),
                                     w.double() @ torch.square(o.double())]).to(dtype))
        result = torch.stack(outgoing).contiguous()
        ctypes.memmove(out, result.data_ptr(), result.numel() * size)
        sums = torch.stack(sums)
        for address, values in ((s1, sums[:, 0]), (s2, sums[:, 1])):
            values = values.contiguous()
            ctypes.memmove(address, values.data_ptr(), values.numel() * size)
        calls.append({"instances": instances, "n": n, "chunk": chunk,
                      "particle_stride": particle_stride, "map_stride": map_stride,
                      "weight_stride": weight_stride})

    return launch


def _card_cases(dtype):
    particles, maps, weights = _inputs("weights_per_instance", dtype)
    broadcast_map = maps[:2, None].expand(2, 3, 7, 7)
    return {
        "env_shared_beam": ((particles, maps, weights[0]), {"particle_stride": 0,
                                                           "map_stride": 49,
                                                           "weight_stride": 0}),
        "weights_per_instance": ((particles, maps, weights), {"weight_stride": 203}),
        "broadcast_map_copied": ((particles[None].expand(3, 203, 7), broadcast_map,
                                  weights[0]), {"map_stride": 49, "particle_stride": 0}),
        "transposed_particles_copied": ((particles.T.contiguous().T, maps, weights[0]),
                                        {"particle_stride": 203 * 7}),
        "one_instance_many_chunks": ((_inputs("particles_off_the_groups", dtype)[0], maps[0],
                                      _inputs("particles_off_the_groups", dtype)[2]),
                                     {"instances": 1}),
    }


@pytest.mark.parametrize("case", ["env_shared_beam", "weights_per_instance",
                                  "broadcast_map_copied", "transposed_particles_copied",
                                  "one_instance_many_chunks"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_card_path_passes_what_the_kernel_reads(monkeypatch, dtype, case):
    """The card path, run on CPU tensors with its launch emulated: one
    launch, counted; the strides at which it reads each instance (a shared
    beam at 0; a layout no single stride reads, copied); and the plain
    version's results."""
    (particles, transfer_map, weights), expected_call = _card_cases(dtype)[case]
    calls = []
    monkeypatch.setattr(fused_transport.LIBRARY, "launch", _emulated_launch(calls))
    # A card of many SMs splits one instance's 1001 particles into chunks.
    monkeypatch.setattr(fused_transport, "_sms", lambda device: 132)
    got, moved = _counted(lambda: fused_transport._kernel(particles, transfer_map, weights))
    assert moved == (1, 0, 0) and len(calls) == 1
    for key, value in expected_call.items():
        assert calls[0][key] == value, (key, calls[0])
    expected = fused_transport._plain(particles, transfer_map, weights)
    tolerance = {F32: 1e-6, F64: 1e-13}[dtype]
    for actual, want in zip(got, expected):
        assert actual.shape == want.shape and actual.is_contiguous()
        torch.testing.assert_close(actual, want, rtol=tolerance, atol=tolerance * want.abs().max())


@pytest.mark.parametrize("instances, n, sms, dtype, chunk", [
    (4096, 10_000, 132, F32, 10_240),
    (4096, 10_000, 132, F64, 10_240),
    (1, 1_000_000, 132, F32, 2_048),
    (3, 1001, 132, F32, 512),
    (1, 1, 132, F64, 256),
])
def test_chunks_fill_the_card_in_whole_tiles(instances, n, sms, dtype, chunk):
    """An instance's particles stay in one block where the instances fill
    the card; otherwise they are cut into whole tiles for about four
    blocks an SM."""
    got = fused_transport.chunk_particles(instances, n, dtype, sms)
    assert got == chunk
    tile = fused_transport.THREADS * (16 // dtype.itemsize)
    assert got % tile == 0 and -(-n // got) * got >= n


# ---------------------------------------------------------------------------
# Compiled
# ---------------------------------------------------------------------------


def test_compiled_env_step_holds_the_transport_and_does_not_trace_again():
    """``BatchedLatticeEnv.step`` under ``torch.compile(fullgraph=True)``:
    the transport is one ``transport_moments`` in the graph, new settings
    do not trace again, and both calls equal the eager step."""
    env = _env(F64, num_particles=200, seed=5)
    graphs = []

    def record(graph_module, example_inputs):
        graphs.append(collections.Counter(
            str(node.target) for node in graph_module.graph.nodes if node.op == "call_function"
        ))
        return make_boxed_func(graph_module.forward)

    torch._dynamo.reset()
    try:
        compiled = torch.compile(env.step, fullgraph=True, dynamic=False,
                                 backend=aot_autograd(fw_compiler=record))
        for index, seed in enumerate((1, 2)):
            settings = _settings(6, F64, seed)
            with torch._dynamo.config.patch(error_on_recompile=index > 0):
                reward = compiled(settings)[2]
            torch.testing.assert_close(reward, env.step(settings)[2], rtol=1e-12, atol=0)
    finally:
        torch._dynamo.reset()
    assert len(graphs) == 1
    assert graphs[0][OPERATOR] == 1
