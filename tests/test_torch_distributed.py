"""The port's multi-device layer across real process boundaries, on the CPU.

Four ranks, each a subprocess running ``torch_parallel_worker.py``, join a
gloo process group through a file store in ``tmp_path`` (no TCP port to
race for between test workers) and run explicit SPMD on their own blocks;
then the first two join a group of two and do the same. The module makes
this one launch of four processes, so that it loads the machine with at
most four ranks at a time and starts each only once:

- ``flat`` (2 ranks): instance-axis tracking, linear and second order; the
  particle-sharded space-charge kick (4000 particles, 8^3) with its loss and
  gradients; the same gradient with a plain in-place all-reduce, which must
  lose the other rank's terms; ``torch.func.jvp`` and ``vmap`` through the
  sharded 32^3 kick against one process; ``BatchedLatticeEnv`` over the instance
  axis; the audit of its grad step; ``replicate``; a sharded checkpoint.
- ``hybrid`` (4 ranks): a 2 x 2 hybrid mesh, the kick with
  ``particle_axis=("hosts", "devices")``, and the audit's axis attribution.

This process computes the same quantities with the JAX package on its
8-device CPU mesh (the unsharded runs and the ``shard_map`` kick) and holds
each rank's numbers against them, in float64: rows to rtol 1e-12, the kick
to rtol 1e-9 / atol 1e-14 (the sharded grid-sizing moments round
differently from the unsharded ones, ``tests/test_parallel.py:321-327``),
the loss to 1e-10 and its gradients to 1e-8
(``tests/distributed_worker.py:298-312``), the env to 1e-10.
"""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import cheetah_tpu as ct
from cheetah_tpu.parallel import BatchedLatticeEnv

TESTS = Path(__file__).parent
WORKER = TESTS / "torch_parallel_worker.py"
TIMEOUT_S = 120
F64 = jnp.float64
NUM_INSTANCES, NUM_ENV_INSTANCES, NUM_SC = 16, 32, 4000
GRID = (8, 8, 8)


def jax_fodo():
    return ct.Segment(
        [
            ct.Drift(jnp.asarray(1.0, F64), name="d1"),
            ct.Quadrupole(jnp.asarray(0.3, F64), k1=jnp.asarray(5.0, F64), name="q1"),
            ct.Drift(jnp.asarray(0.5, F64), name="d2"),
            ct.Quadrupole(jnp.asarray(0.3, F64), k1=jnp.asarray(-4.0, F64), name="q2"),
            ct.Drift(jnp.asarray(1.0, F64), name="d3"),
        ],
        name="fodo",
    )


def _beam_arrays(prefix, beam):
    return {
        f"{prefix}_particles": np.asarray(beam.particles),
        f"{prefix}_energy": np.asarray(beam.energy),
        f"{prefix}_charges": np.asarray(beam.particle_charges),
        f"{prefix}_survival": np.asarray(beam.survival_probabilities),
    }


def _numpy_beam(seed, shape, sigmas, total_charge=1e-10, energy=1.5e8):
    """A Gaussian beam of ``shape`` (instances..., particles) made with
    numpy, so that both packages track the same particles. ``sigmas`` are
    those of x, px, y, py, tau, p."""
    rng = np.random.default_rng(seed)
    particles = np.concatenate(
        [rng.normal(size=(*shape, 6)) * np.asarray(sigmas), np.ones((*shape, 1))], axis=-1
    )
    charges = np.full(shape, total_charge / shape[-1])
    return ct.ParticleBeam(
        particles=jnp.asarray(particles), energy=jnp.asarray(energy, F64),
        particle_charges=jnp.asarray(charges), survival_probabilities=jnp.ones(shape, F64),
    )


TRANSVERSE = (1e-4, 2e-7, 1e-4, 2e-7, 1e-6, 1e-6)


def _sc_loss(beam, effect_length, drift_length):
    segment = ct.Segment([
        ct.Drift(drift_length),
        ct.SpaceChargeKick(effect_length, grid_shape=GRID),
        ct.Drift(jnp.asarray(0.25, F64)),
    ])
    out = segment.track(beam).particles
    return jnp.mean(jnp.square(out[..., 1]) + jnp.square(out[..., 3]))


@pytest.fixture(scope="module")
def beams():
    return {
        "inst": _numpy_beam(7, (NUM_INSTANCES, 512), TRANSVERSE),
        # The beam sizes of test_shard_map_space_charge_matches_unsharded.
        "sc": _numpy_beam(42, (NUM_SC,), (1.7e-4, 2e-7, 1.7e-4, 2e-7, 1e-5, 1e-3),
                          total_charge=1e-9),
        "env": _numpy_beam(5, (256,), TRANSVERSE),
        "ares": _numpy_beam(3, (4096,), (1.7e-4, 2e-7, 1e-4, 2e-7, 1e-6, 1e-6)),
    }


@pytest.fixture(scope="module")
def inputs(beams):
    settings = np.stack(
        [np.linspace(2.0, 8.0, NUM_ENV_INSTANCES), np.linspace(-8.0, -2.0, NUM_ENV_INSTANCES)],
        axis=-1,
    )
    arrays = {}
    for prefix, beam in beams.items():
        arrays.update(_beam_arrays(prefix, beam))
    return {
        **arrays,
        "inst_k1": np.linspace(-10.0, 10.0, NUM_INSTANCES),
        "env_settings": settings,
        "ares_settings": np.linspace(-20.0, 20.0, 64)[:, None],
    }


@pytest.fixture(scope="module")
def expected(inputs, beams):
    """The JAX package's numbers for the same inputs (under ``jax.jit``:
    op by op the JAX package takes several times longer on the CPU)."""
    results = {}
    track = jax.jit(lambda segment, beam: segment.track(beam).sigma_x)
    for method in ("linear", "second_order"):
        segment = jax_fodo()
        segment.q1.tracking_method = method
        segment.q1.k1 = jnp.asarray(inputs["inst_k1"])
        results[f"sigma_x_{method}"] = np.asarray(track(segment, beams["inst"]))

    beam = beams["sc"]
    kick = ct.SpaceChargeKick(jnp.asarray(0.25, F64), grid_shape=GRID)
    results["kicked"] = np.asarray(jax.jit(lambda kick, beam: kick.track(beam).particles)(kick, beam))
    mesh = Mesh(np.array(jax.devices()), ("particles",))
    sharded_kick = ct.SpaceChargeKick(
        jnp.asarray(0.25, F64), grid_shape=GRID, particle_axis="particles"
    )

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P("particles", None), P("particles"), P("particles")),
             out_specs=P("particles", None))
    def kicked_shard(particles, charges, survival):
        local = ct.ParticleBeam(particles=particles, energy=beam.energy,
                                particle_charges=charges, survival_probabilities=survival,
                                species=beam.species)
        return sharded_kick.track(local).particles

    results["kicked_shard_map"] = np.asarray(
        kicked_shard(beam.particles, beam.particle_charges, beam.survival_probabilities)
    )
    loss, grads = jax.jit(jax.value_and_grad(partial(_sc_loss, beam), argnums=(0, 1)))(
        jnp.asarray(0.5, F64), jnp.asarray(0.25, F64)
    )
    results["loss"], results["grad_effect_length"], results["grad_drift_length"] = (
        float(loss), float(grads[0]), float(grads[1])
    )

    env = BatchedLatticeEnv(jax_fodo(), beams["env"], tunables=[("q1", "k1"), ("q2", "k1")])
    step = jax.jit(env.grad_step)
    settings, trajectory = jnp.asarray(inputs["env_settings"]), []
    for _ in range(5):
        settings, reward = step(settings, 1e4)
        trajectory.append(np.asarray(settings))
    results["env_settings_after"] = np.stack(trajectory)
    results["env_reward"] = np.asarray(reward)
    return results


def _launch(jobs: dict, directory: Path, inputs: dict,
            local_world_size: int | None = None) -> dict:
    """One launch of ``max(jobs.values())`` rank processes that run the jobs
    (name: world size) in turn; each job's results by rank."""
    world_size = max(jobs.values())
    job = ",".join(f"{name}:{size}" for name, size in jobs.items())
    np.savez(directory / "inputs.npz", **inputs)
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(TESTS.parent), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR"):
        env.pop(key, None)
    if local_world_size is not None:
        env["LOCAL_WORLD_SIZE"] = str(local_world_size)
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), job, str(rank), str(world_size), str(directory)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=str(TESTS.parent),
        )
        for rank in range(world_size)
    ]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        pytest.fail(f"{job}: ranks timed out after {TIMEOUT_S} s:\n" + "\n".join(outputs))
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"{job} rank {rank} failed:\n{out}"
    return {
        name: [dict(np.load(directory / f"{name}_rank{rank}.npz")) for rank in range(size)]
        for name, size in jobs.items()
    }


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """The one multi-rank launch of this module: four processes run the
    hybrid job, then the first two the flat job on a group of their own
    (two nodes of two ranks for the hybrid mesh, ``LOCAL_WORLD_SIZE=2``)."""
    directory = tmp_path_factory.mktemp("ranks")
    return directory, _launch({"hybrid": 4, "flat": 2}, directory, inputs, local_world_size=2)


@pytest.fixture(scope="module")
def flat(launched):
    directory, jobs = launched
    return directory, jobs["flat"]


@pytest.fixture(scope="module")
def hybrid(launched):
    return launched[1]["hybrid"]


def _ranks(request, name):
    job = request.getfixturevalue(name)
    return job[1] if name == "flat" else job


@pytest.mark.parametrize("method", ["linear", "second_order"])
def test_instance_axis_rows_match_jax(flat, expected, method):
    """Each rank's rows of sigma_x are JAX's unsharded rows of its block,
    and ``all_gather`` puts the blocks together."""
    _, ranks = flat
    blocks = np.split(expected[f"sigma_x_{method}"], 2)
    for rank, result in enumerate(ranks):
        np.testing.assert_allclose(result[f"sigma_x_{method}"], blocks[rank], rtol=1e-12)
        np.testing.assert_allclose(result[f"gathered_{method}"], expected[f"sigma_x_{method}"],
                                   rtol=1e-12)


@pytest.mark.parametrize("job", ["flat", "hybrid"])
@pytest.mark.parametrize("reference", ["kicked", "kicked_shard_map"])
def test_particle_sharded_kick_matches_jax(request, expected, job, reference):
    """2 ranks over one axis and 4 over ("hosts", "devices"): the ranks'
    kicked particles, put together, are JAX's unsharded and shard_map kick."""
    ranks = _ranks(request, job)
    kicked = np.concatenate([result["kicked"] for result in ranks])
    np.testing.assert_allclose(kicked, expected[reference], rtol=1e-9, atol=1e-14)


def test_particle_axis_as_process_group(flat):
    _, ranks = flat
    for result in ranks:
        np.testing.assert_array_equal(result["kicked_by_group"], result["kicked"])


@pytest.mark.parametrize("job", ["flat", "hybrid"])
@pytest.mark.parametrize(
    "name, rtol",
    [("loss", 1e-10), ("grad_effect_length", 1e-8), ("grad_drift_length", 1e-8)],
)
def test_sharded_kick_loss_and_gradients_match_jax(request, expected, job, name, rtol):
    """By the port's gradient convention (each rank's own share, then an
    all-reduce of the replicated parameters' gradients) every rank holds
    JAX's loss and its gradients by the kick's length and a drift's."""
    for result in _ranks(request, job):
        np.testing.assert_allclose(float(result[name]), expected[name], rtol=rtol)


def test_plain_in_place_all_reduce_loses_the_gradient(flat, expected):
    """The drift length moves the particles, so its gradient runs back
    through both of the kick's all-reduces: with a plain in-place
    ``torch.distributed.all_reduce`` in place of the port's, each rank
    drops the other's terms and the test above would fail."""
    _, ranks = flat
    for result in ranks:
        plain = float(result["grad_drift_length_plain"])
        assert not np.isclose(plain, expected["grad_drift_length"], rtol=1e-8, atol=0.0), plain


@pytest.mark.parametrize("name", ["value", "jvp", "vmap"])
def test_func_transforms_through_the_collectives_match_one_process(flat, name):
    """``torch.func.jvp`` and ``torch.func.vmap`` of the particle-sharded
    32^3 kick's loss: the all-reduces' jvp and vmap rules give each rank
    the one-process values (``_AllReduce`` without them fails under both
    transforms)."""
    _, ranks = flat
    for result in ranks:
        np.testing.assert_allclose(result[f"func_{name}"], result[f"func_{name}_one_process"],
                                   rtol=1e-10)
    assert ranks[0][f"func_{name}"].shape == ((2,) if name == "vmap" else ())


def test_env_grad_steps_over_the_instance_axis_match_jax(flat, expected):
    """Five grad steps of ``BatchedLatticeEnv`` on each rank's 16 of the 32
    instances equal the JAX env's steps on all of them."""
    _, ranks = flat
    for rank, result in enumerate(ranks):
        rows = slice(16 * rank, 16 * (rank + 1))
        np.testing.assert_allclose(result["env_settings_after"],
                                   expected["env_settings_after"][:, rows], rtol=1e-10)
        np.testing.assert_allclose(result["env_reward"], expected["env_reward"][rows], rtol=1e-10)


def test_env_grad_step_audit_is_readout_sized(flat):
    """The env's grad step issues no collective; the mean reward's sum is
    the one all-reduce, 8 bytes across the instance axis."""
    _, ranks = flat
    for result in ranks:
        assert list(result["audit_lines"]) == ["all-reduce f64[] replica_groups={{0,1}}"]
        assert int(result["audit_dcn_bytes"]) == 8


def test_hybrid_mesh_lays_nodes_first(hybrid):
    """Two nodes of two ranks (``LOCAL_WORLD_SIZE=2``): the hosts axis
    spans the nodes, the devices axis a node's consecutive ranks; by default
    one axis of each; axes that do not match the nodes are refused."""
    for result in hybrid:
        np.testing.assert_array_equal(result["mesh_ranks"], [[0, 1], [2, 3]])
        assert list(result["default_mesh"]) == ["hosts", "devices", "2", "2"]
        assert bool(result["refused_mismatch"])


def test_audit_attributes_the_kick_to_both_axes(hybrid):
    """The kick's value_and_grad over ("hosts", "devices"): the moment sums
    (4 x 3 x 1 doubles) and the 8^3 grid, forward and backward, all over
    the four ranks; an all-reduce over "devices" alone crosses no host."""
    moments, grid = 4 * 3 * 8, 8**3 * 8
    for result in hybrid:
        assert len(result["kick_lines"]) == 4
        assert all("replica_groups={{0,1,2,3}}" in line for line in result["kick_lines"])
        assert int(result["kick_dcn_bytes"]) == 2 * (moments + grid)
        assert int(result["kick_devices_bytes"]) == 2 * (moments + grid)
        assert int(result["devices_only_dcn_bytes"]) == 0
        assert int(result["devices_only_bytes"]) == 4 * 8


def test_env_gradient_across_hosts_is_readout_sized(hybrid, inputs):
    """The ARES EA env step's gradient with 64 settings over hosts x
    devices moves one loss scalar across hosts, not the particles
    (``tests/test_parallel.py:367-410``)."""
    particle_bytes = inputs["ares_particles"].size * 8
    assert particle_bytes > 200_000
    for result in hybrid:
        assert int(result["env_ops"]) == 1
        assert int(result["env_dcn_bytes"]) < 4096
        assert int(result["env_dcn_bytes"]) < particle_bytes / 100


def test_replicate_broadcasts_the_first_rank(flat):
    _, ranks = flat
    for result in ranks:
        assert float(result["replicated_k1"]) == 1.0


def test_sharded_checkpoint_round_trips_each_rank_shard(flat, inputs):
    """Each rank restores its own particles from the checkpoint that both
    wrote, one file each; a second save without ``overwrite`` is refused."""
    directory, ranks = flat
    blocks = np.split(inputs["sc_particles"], 2)
    for rank, result in enumerate(ranks):
        np.testing.assert_array_equal(result["restored_local"], blocks[rank])
        np.testing.assert_array_equal(result["restored_global_shape"], [NUM_SC, 7])
        assert bool(result["refused_overwrite"])
    shards = sorted(path.name for path in (directory / "beam_checkpoint").glob("*.distcp"))
    assert len(shards) == 2, shards
