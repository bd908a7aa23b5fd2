"""A space-charge segment through ``torch.export``, on the CPU: the port's
counterpart of exporting a lattice whose kicks reach the JAX package's CIC
primitives.

The segment is Drift -> SpaceChargeKick -> Drift, on an 8^3 grid (the
untiled pair) and on 128^3 (the x-tiled pair and its tile plans), in
float32 and float64, exported from ``aot.TrackReadout`` with the particle
axis symbolic. Its graph holds the ``cheetah_tpu_torch::cic_*`` operators
and none of the operators of their plain versions; saved and loaded, the
program equals eager tracking bit for bit at two particle counts (on CPU
tensors both run the same plain versions). In float64 it agrees with the
JAX package's ``jax.export`` of the same step on the same numpy arrays
within 1.3e-6 of the largest kick: the JAX package's own jitted and eager
kicks differ by up to that much (ROADMAP, the known behaviours). The same
holds with a per-instance drift length over 4 instances.

On a card the same program launches the hand-written kernels:
``chip_smoke.py``'s ``deploy_space_charge`` phase holds that.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export

import cheetah_tpu as ct
from cheetah_tpu.utils import aot as jax_aot
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.utils import aot
from test_torch_tracking import segment_to_torch

GRIDS = {"8": (8, 8, 8), "128": (128, 128, 128)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
#: The operators of the exported segment (one kick), by grid: the untiled
#: pair on 8^3; on 128^3 the x-tiled pair and the plan of each of its two
#: autograd nodes.
OPERATORS = {
    "8": {"cheetah_tpu_torch.cic_deposit_multi.default": 1,
          "cheetah_tpu_torch.cic_gather_multi.default": 1},
    "128": {"cheetah_tpu_torch.cic_tile_plan.default": 2,
            "cheetah_tpu_torch.cic_deposit_tiled.default": 1,
            "cheetah_tpu_torch.cic_gather_tiled.default": 1},
}
#: What the plain versions leave in a graph: the deposit's index_add_, the
#: gather's gather, the tiled gather's scatter_, the plan's sort and
#: searchsorted. (The kick's own out-of-place index_add on the momentum
#: columns is aten.index_add.)
PLAIN_TARGETS = ("aten.index_add_.", "aten.gather.", "aten.scatter_.", "aten.sort.",
                 "aten.searchsorted.")
KICK_BOUND = 1.3e-6
LENGTHS = (0.05, 0.1, 0.15, 0.2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the 128^3 grid's FFTs would otherwise take
    every core, beside the suite's wall-clock checks (``tests/test_speed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def beam_arrays(num_particles, seed):
    """A 1 nC beam at 154 MeV, drawn with numpy, float64."""
    rng = np.random.default_rng(seed)
    sigmas = np.array([1e-4, 2e-5, 1e-4, 2e-5, 1e-5, 1e-4])
    particles = np.concatenate(
        [rng.normal(size=(num_particles, 6)) * sigmas, np.ones((num_particles, 1))], axis=-1
    )
    return {
        "particles": particles,
        "energy": np.asarray(1.54e8),
        "particle_charges": np.full(num_particles, 1e-9 / num_particles),
        "survival_probabilities": np.ones(num_particles),
    }


def port_beam(arrays, dtype):
    return interop.particle_beam_from_numpy(
        *(arrays[key].astype(np.float32 if dtype == torch.float32 else np.float64)
          for key in ("particles", "energy", "particle_charges", "survival_probabilities")),
        device="cpu",
    )


def jax_beam(arrays):
    return ct.ParticleBeam(**{key: jnp.asarray(value) for key, value in arrays.items()})


def jax_segment(grid, lengths=None):
    return ct.Segment([
        ct.Drift(jnp.asarray(0.1 if lengths is None else lengths)),
        ct.SpaceChargeKick(jnp.asarray(0.2), grid_shape=grid),
        ct.Drift(jnp.asarray(0.1)),
    ])


def port_segment(grid, dtype, lengths=None):
    segment = segment_to_torch(jax_segment(grid, lengths))
    return segment.to(dtype)


def export_and_load(segment, beam, path):
    """The exported step (``particles`` after the segment), the particle
    axis symbolic, with its graph's call targets; saved and loaded back."""
    step = aot.TrackReadout(segment, "particles", beam.species)
    exported = torch.export.export(step, aot.beam_arguments(beam),
                                   dynamic_shapes=aot.symbolic_particle_beam(beam))
    targets = collections.Counter(
        str(node.target) for node in exported.graph.nodes if node.op == "call_function"
    )
    torch.export.save(exported, str(path))
    return torch.export.load(str(path)).module(), targets


def _check_graph(targets, grid):
    operators = {name: count for name, count in targets.items()
                 if name.startswith("cheetah_tpu_torch.")}
    assert operators == OPERATORS[grid]
    assert not [name for name in targets if name.startswith(PLAIN_TARGETS)], targets


def _kick_errors(actual, expected, before):
    """Per momentum (px, py, p): max |kick difference| over the largest
    expected kick."""
    errors = []
    for index in (1, 3, 5):
        kick_expected = np.asarray(expected)[..., index] - before[..., index]
        kick_actual = actual.numpy()[..., index] - before[..., index]
        size = np.abs(kick_expected).max()
        assert size > 0
        errors.append(np.abs(kick_actual - kick_expected).max() / size)
    return errors


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", GRIDS)
def test_exported_segment_holds_the_operators_and_equals_eager(tmp_path, grid, dtype):
    segment = port_segment(GRIDS[grid], DTYPES[dtype])
    program, targets = export_and_load(
        segment, port_beam(beam_arrays(1_500, 0), DTYPES[dtype]), tmp_path / "sc.pt2"
    )
    _check_graph(targets, grid)
    for num_particles in (1_000, 2_500):
        beam = port_beam(beam_arrays(num_particles, num_particles), DTYPES[dtype])
        got = program(*aot.beam_arguments(beam))
        want = segment.track(beam).particles
        assert got.dtype == DTYPES[dtype] and got.shape == (num_particles, 7)
        assert torch.equal(got, want), num_particles


@pytest.mark.parametrize("grid", GRIDS)
def test_exported_segment_matches_the_jax_export(tmp_path, grid):
    """float64: the loaded program and ``jax.export`` of the same step,
    both with the particle axis symbolic, on the same arrays."""
    segment = port_segment(GRIDS[grid], torch.float64)
    program, _ = export_and_load(segment, port_beam(beam_arrays(1_500, 0), torch.float64),
                                 tmp_path / "sc.pt2")
    jsegment = jax_segment(GRIDS[grid])
    step = jax.jit(lambda s, b: s.track(b).particles)
    exported = export.export(step)(
        jax_aot.abstract_like(jsegment),
        jax_aot.symbolic_particle_beam(jax_beam(beam_arrays(1_500, 0))),
    )
    rehydrated = export.deserialize(exported.serialize())
    for num_particles in (1_000, 2_500):
        arrays = beam_arrays(num_particles, num_particles + 1)
        got = program(*aot.beam_arguments(port_beam(arrays, torch.float64)))
        want = rehydrated.call(jsegment, jax_beam(arrays))
        errors = _kick_errors(got, want, arrays["particles"])
        assert max(errors) <= KICK_BOUND, (num_particles, errors)


@pytest.mark.parametrize("grid", GRIDS)
def test_exported_vectorised_segment(tmp_path, grid):
    """A per-instance first drift over 4 instances, float64: the loaded
    program equals eager tracking bit for bit and the JAX package's
    exported step within the kick bound."""
    segment = port_segment(GRIDS[grid], torch.float64, LENGTHS)
    program, targets = export_and_load(
        segment, port_beam(beam_arrays(1_500, 0), torch.float64), tmp_path / "sc.pt2"
    )
    _check_graph(targets, grid)
    jsegment = jax_segment(GRIDS[grid], LENGTHS)
    step = jax.jit(lambda s, b: s.track(b).particles)
    exported = export.export(step)(
        jax_aot.abstract_like(jsegment),
        jax_aot.symbolic_particle_beam(jax_beam(beam_arrays(1_500, 0))),
    )
    rehydrated = export.deserialize(exported.serialize())
    for num_particles in (1_000, 2_000):
        arrays = beam_arrays(num_particles, num_particles + 2)
        beam = port_beam(arrays, torch.float64)
        got = program(*aot.beam_arguments(beam))
        assert got.shape == (len(LENGTHS), num_particles, 7)
        assert torch.equal(got, segment.track(beam).particles)
        want = rehydrated.call(jsegment, jax_beam(arrays))
        errors = _kick_errors(got, want, arrays["particles"])
        assert max(errors) <= KICK_BOUND, (num_particles, errors)
