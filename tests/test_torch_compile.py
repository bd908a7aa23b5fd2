"""``torch.compile`` of the port's tracking on the CPU: the counterpart of
the JAX package's ``jax.jit`` (``cheetah_tpu/accelerator/segment.py:8-9``).

Each path is compiled with ``fullgraph=True`` and ``dynamic=False``, so a
graph break raises instead of running pieces eagerly:

1. the ARES EA env step (``segment.track(beam).sigma_x``, ``bench.py``);
2. its gradient with respect to the per-instance ``k1``;
3. the ParameterBeam env step (BASELINE config 1) and ``track_moments``;
4. and 5. the space-charge segment and its gradient (in
   ``test_torch_compile_space_charge.py``, which shares this file's
   helpers);
6. ``BatchedLatticeEnv.step`` and ``grad_step`` with the five ARES EA
   tunables (BASELINE config 5);
7. the exported env step that AOTInductor compiles: its particle axis
   bounded, so that the package indexes in 64 bits where it must.

For each: the second call, with new parameter values of the same shapes,
is not traced again (``error_on_recompile``); both calls equal the
uncompiled call; and both agree with the JAX package under ``jax.jit`` on
the same numpy-made inputs, values and ``jax.grad`` gradients, in float64.
Dynamo runs with the ``aot_eager`` backend, which hands AOTAutograd the
graphs Inductor gets and runs them op by op. One case compiles the env
step with Inductor itself (it caught a miscompile of the transfer maps'
``index_copy``).

On the card, ``chip_smoke.py``'s ``compiled`` phase drives the same paths
with Inductor at the full widths.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functorch.compile import make_boxed_func
from torch._dynamo.backends.common import aot_autograd

import cheetah_tpu as ct
import cheetah_tpu.parallel as jax_parallel
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from cheetah_tpu_torch import interop, parallel
from cheetah_tpu_torch.utils import aot
from test_torch_tracking import beam_to_torch, segment_to_torch

F64 = torch.float64
#: The compiled call against the uncompiled one, both float64 on the CPU:
#: AOTAutograd's decompositions may round a sum in another order (none
#: did when measured), so not bit for bit.
EAGER_RTOL = 1e-12
#: The port against the JAX package under jax.jit, float64.
JAX_RTOL = 1e-10
TUNABLES = [("AREAMQZM1", "k1"), ("AREAMQZM2", "k1"), ("AREAMQZM3", "k1"),
            ("AREAMCVM1", "angle"), ("AREAMCHM1", "angle")]
K1_VALUES = (np.linspace(-20.0, 20.0, 6), np.linspace(-12.0, 15.0, 6))


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    """Every test traces anew: a compiled function of an earlier test
    neither serves nor counts against this one."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _jax_twiss_beam(num_particles, seed, **extra):
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    return ct.ParticleBeam.from_twiss(
        num_particles=num_particles, beta_x=a(5.0), alpha_x=a(-1.0), emittance_x=a(2e-9),
        beta_y=a(3.0), alpha_y=a(0.5), emittance_y=a(2e-9), energy=a(1.54e8),
        total_charge=a(1e-10), key=jax.random.PRNGKey(seed), dtype=jnp.float64,
        **{k: a(v) for k, v in extra.items()},
    )


def _numpy(outputs):
    return [output.detach().numpy() for output in outputs]


def _compiled_matches_eager(fn, run, values, backend="aot_eager"):
    """Compile ``fn`` (``fullgraph=True``, ``dynamic=False``); for each of
    ``values``, ``run(f, value)`` sets the parameters and calls ``f``, the
    compiled function or ``fn`` itself. The calls after the first must not
    trace again, and each equals the uncompiled call. Returns the compiled
    calls' outputs as numpy arrays."""
    compiled = torch.compile(fn, fullgraph=True, dynamic=False, backend=backend)
    results = []
    for index, value in enumerate(values):
        with torch._dynamo.config.patch(error_on_recompile=index > 0):
            got = _numpy(run(compiled, value))
        for actual, expected in zip(got, _numpy(run(fn, value))):
            np.testing.assert_allclose(actual, expected, rtol=EAGER_RTOL, atol=0)
        results.append(got)
    return results


def _recording(graphs):
    """``aot_eager`` that keeps the operators of each graph AOTAutograd
    hands on (forward and backward)."""

    def record(graph_module, example_inputs):
        graphs.append(collections.Counter(
            str(node.target) for node in graph_module.graph.nodes if node.op == "call_function"
        ))
        return make_boxed_func(graph_module.forward)

    return aot_autograd(fw_compiler=record, bw_compiler=record)


# ---------------------------------------------------------------------------
# Paths 1-3: the env step, its gradient, the ParameterBeam env step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env_case():
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64)
    jax_beam = _jax_twiss_beam(300, 3)
    return jax_segment, jax_beam, segment_to_torch(jax_segment), beam_to_torch(jax_beam)


def _jax_env_step(k1, segment, beam):
    segment.AREAMQZM1.k1 = k1
    return segment.track(beam).sigma_x


@pytest.mark.parametrize("backend", ["aot_eager", "inductor"])
def test_env_step_compiles_and_matches_jax(env_case, backend):
    """Path 1, the main path: one graph, k1 assigned between calls."""
    jax_segment, jax_beam, segment, beam = env_case

    def run(f, k1):
        segment.AREAMQZM1.k1 = torch.tensor(k1)
        return (f(segment, beam),)

    results = _compiled_matches_eager(lambda s, b: s.track(b).sigma_x, run, K1_VALUES,
                                      backend=backend)
    jitted = jax.jit(_jax_env_step)
    for (sigma_x,), k1 in zip(results, K1_VALUES):
        expected = np.asarray(jitted(jnp.asarray(k1), jax_segment, jax_beam))
        np.testing.assert_allclose(sigma_x, expected, rtol=JAX_RTOL)


def test_env_step_k1_gradient_compiles_and_matches_jax(env_case):
    """Path 2: the compiled forward, differentiated outside it (AOTAutograd
    compiles the backward), against ``jax.grad`` under ``jax.jit``; one
    instance at exactly k1 = 0."""
    jax_segment, jax_beam, segment, beam = env_case
    values = (np.linspace(-20.0, 20.0, 5), np.linspace(-10.0, 14.0, 5))
    assert values[0][2] == 0

    def run(f, k1):
        k1 = torch.tensor(k1, requires_grad=True)
        segment.AREAMQZM1.k1 = k1
        value = f(segment, beam)
        return value, torch.autograd.grad(value, k1)[0]

    results = _compiled_matches_eager(lambda s, b: s.track(b).sigma_x.sum(), run, values)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda k1, s, b: jnp.sum(_jax_env_step(k1, s, b))
    ))
    for (value, grad), k1 in zip(results, values):
        expected_value, expected_grad = value_and_grad(jnp.asarray(k1), jax_segment, jax_beam)
        np.testing.assert_allclose(value, float(expected_value), rtol=JAX_RTOL)
        assert np.all(np.isfinite(grad))
        np.testing.assert_allclose(grad, np.asarray(expected_grad), rtol=JAX_RTOL)


@pytest.mark.parametrize("method", ["track", "track_moments"])
def test_parameter_beam_env_step_compiles_and_matches_jax(env_case, method):
    """Path 3: BASELINE config 1, a ParameterBeam through the env step, and
    ``track_moments`` of the particle beam (its plan of fused runs)."""
    jax_segment, jax_beam, segment, beam = env_case
    if method == "track":
        jax_beam = ct.ParameterBeam.from_twiss(
            beta_x=jnp.asarray(5.0), emittance_x=jnp.asarray(2e-9), beta_y=jnp.asarray(3.0),
            emittance_y=jnp.asarray(2e-9), energy=jnp.asarray(1.54e8), dtype=jnp.float64,
        )
        beam = interop.parameter_beam_from_numpy(
            np.asarray(jax_beam.mu), np.asarray(jax_beam.cov), np.asarray(jax_beam.energy),
            np.asarray(jax_beam.total_charge), np.asarray(jax_beam.s), jax_beam.species.name,
            device="cpu",
        )

    def run(f, k1):
        segment.AREAMQZM1.k1 = torch.tensor(k1)
        return f(segment, beam)

    def step(s, b):
        out = getattr(s, method)(b)
        return out.sigma_x, out.sigma_y

    def jax_step(k1, s, b):
        s.AREAMQZM1.k1 = k1
        out = getattr(s, method)(b)
        return out.sigma_x, out.sigma_y

    results = _compiled_matches_eager(step, run, K1_VALUES)
    jitted = jax.jit(jax_step)
    for outputs, k1 in zip(results, K1_VALUES):
        for actual, expected in zip(outputs, jitted(jnp.asarray(k1), jax_segment, jax_beam)):
            np.testing.assert_allclose(actual, np.asarray(expected), rtol=JAX_RTOL)


def test_compiled_step_refuses_a_lattice_on_another_device(env_case):
    """The device check runs while the step is traced: a parameter on
    another device than the beam stops the compile with the eager error's
    text, as it stops the eager call."""
    _, jax_beam, _, beam = env_case
    segment = segment_to_torch(jax_ares_ea_subcell(dtype=jnp.float64))
    segment.AREAMQZM1.k1 = torch.tensor(1.0, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="is on device meta"):
        segment.track(beam)
    compiled = torch.compile(lambda s, b: s.track(b).sigma_x, fullgraph=True, backend="aot_eager")
    with pytest.raises(Exception, match="is on device meta"):
        compiled(segment, beam)


def test_exported_particle_axis_is_bounded_past_32_bit_indexing(env_case):
    """Path 7's export: the particle axis has a finite bound under which the
    env step's particles (4096 x N x 7) can outgrow 32-bit indices. Without
    a bound AOTInductor indexes in int32 whenever the example beam fits,
    and checks nothing at run time (the env step's package exported from
    10k particles faulted at 100k on the card); with one it indexes in 64
    bits."""
    _, _, segment, beam = env_case
    exported = torch.export.export(
        aot.TrackReadout(segment, "sigma_x", beam.species), aot.beam_arguments(beam),
        dynamic_shapes=aot.symbolic_particle_beam(beam),
    )
    assert {bounds.upper for bounds in exported.range_constraints.values()} == {
        aot.MAX_PARTICLES
    }
    assert 4096 * aot.MAX_PARTICLES * 7 > torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# Path 6: BatchedLatticeEnv, BASELINE config 5
# ---------------------------------------------------------------------------


def _settings(seed, instances=6):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-20, 20, (instances, 3)),
                           rng.uniform(-1e-3, 1e-3, (instances, 2))], axis=1)


@pytest.mark.parametrize("method", ["step", "grad_step"])
def test_batched_env_compiles_and_matches_jax(env_case, method):
    """Path 6: ``env.step`` and ``env.grad_step`` compiled as the user calls
    them (the settings assigned to the lattice's buffers inside the step
    and restored after it), new settings every call."""
    jax_segment, jax_beam, segment, beam = env_case
    env = parallel.BatchedLatticeEnv(segment, beam, TUNABLES)
    jax_env = jax_parallel.BatchedLatticeEnv(jax_segment, jax_beam, tunables=TUNABLES)
    values = (_settings(1), _settings(2))
    saved = segment.AREAMQZM1.k1

    if method == "step":

        def run(f, settings):
            outgoing, readings, reward = f(torch.tensor(settings))
            assert readings == {}
            return reward, outgoing.sigma_x

        def jax_run(settings):
            outgoing, _, reward = jax.jit(jax_env.step)(settings)
            return reward, outgoing.sigma_x

    else:

        def run(f, settings):
            return f(torch.tensor(settings), 1e4)

        def jax_run(settings):
            return jax.jit(jax_env.grad_step)(settings, 1e4)

    results = _compiled_matches_eager(getattr(env, method), run, values)
    assert segment.AREAMQZM1.k1 is saved
    for outputs, settings in zip(results, values):
        expected = [np.asarray(output) for output in jax_run(jnp.asarray(settings))]
        np.testing.assert_allclose(outputs[1], expected[1], rtol=JAX_RTOL)
        if method == "step":
            np.testing.assert_allclose(outputs[0], expected[0], rtol=JAX_RTOL)
            continue
        # The steps taken: the k1 gradients agree; the angle gradients are
        # zero (sigma does not depend on the centroid) up to rounding, 1e-16
        # to 1e-15 in both packages, which is 1e-10 of the k1 gradients.
        step, expected_step = (outputs[0] - settings) / 1e4, (expected[0] - settings) / 1e4
        np.testing.assert_allclose(step[:, :3], expected_step[:, :3], rtol=JAX_RTOL)
        largest = np.abs(expected_step[:, :3]).max()
        assert np.abs(step[:, 3:]).max() <= 1e-9 * largest
        assert np.abs(expected_step[:, 3:]).max() <= 1e-9 * largest
