"""The port's multi-device layer in one process (world size 1, gloo), on the
CPU, against the JAX package on its 8-device CPU mesh, in float64.

A process group of one rank joins through a file store in ``tmp_path``.
With it: meshes (``make_mesh``, ``make_hybrid_mesh``), ``initialize``
(a bare call is a no-op on one process and raises where the environment
shows several workers), the particle-sharded space-charge kick over a
one-rank axis (its all-reduces are real gloo calls) against the JAX
package's unsharded and ``shard_map`` kicks, ``BatchedLatticeEnv`` against
the JAX env (``step``, ``reward``, BPM readings, ``moments_only``, five
``grad_step``\\ s, and a hundred that raise the mean reward), the sharding
helpers' layouts against ``beam_shardings``, the audit's parser against the
JAX package's on the same collectives, and checkpoints that the JAX package
wrote and reads. The cases across real process boundaries are in
``test_torch_distributed.py``.
"""

import os
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import cheetah_tpu as ct
import cheetah_tpu.parallel as jax_parallel
import cheetah_tpu_torch as ctt
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from cheetah_tpu.parallel.comm_audit import parse_collectives as jax_parse_collectives
from cheetah_tpu.utils import checkpoint as jax_checkpoint
from cheetah_tpu_torch import parallel
from cheetah_tpu_torch.lattices import ares_ea_subcell
from cheetah_tpu_torch.parallel import collectives, comm_audit, sharding
from cheetah_tpu_torch.utils import checkpoint
from test_torch_distributed import TRANSVERSE, _numpy_beam, jax_fodo
from test_torch_tracking import beam_to_torch, segment_to_torch
from torch_parallel_worker import fodo

F64 = torch.float64
CPU = "cpu"
GRID = (8, 8, 8)


@pytest.fixture(scope="module", autouse=True)
def process_group(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "store"
    parallel.initialize(f"file://{store}", 1, 0)
    yield
    dist.destroy_process_group()


@pytest.fixture
def mesh():
    return parallel.make_mesh({"particles": 1})


def test_make_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh()


def test_mesh_construction():
    mesh = parallel.make_mesh()
    assert mesh.mesh_dim_names == ("instances",) and tuple(mesh.mesh.shape) == (1,)
    mesh2 = parallel.make_mesh({"instances": 1, "particles": 1})
    assert mesh2.mesh_dim_names == ("instances", "particles")
    hybrid = parallel.make_hybrid_mesh()
    assert hybrid.mesh_dim_names == ("hosts", "devices") and tuple(hybrid.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        parallel.make_mesh({"instances": 2})


def _clean_cluster_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)


def test_bare_initialize_is_noop_single_process(monkeypatch):
    """As ``tests/test_distributed.py:108-126``: a bare call on a plain
    process does nothing, and raises where the environment shows several
    workers but no way to join them."""
    _clean_cluster_environment(monkeypatch)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append(a))
    parallel.initialize()
    assert calls == []
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(RuntimeError, match="2 workers"):
        parallel.initialize()
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="4 workers"):
        parallel.initialize()


def test_initialize_arguments(monkeypatch):
    """Idempotent once joined; explicit arguments go to
    ``init_process_group``; the CPU backend is checked."""
    parallel.initialize("localhost:1", 2, 1)  # joined already: nothing happens
    assert dist.get_world_size() == 1
    _clean_cluster_environment(monkeypatch)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    parallel.initialize("localhost:1234", 2, 1)
    ((backend,), kwargs) = calls[0]
    assert backend == "gloo" and kwargs["init_method"] == "tcp://localhost:1234"
    assert (kwargs["world_size"], kwargs["rank"]) == (2, 1)
    with pytest.raises(ValueError, match="cpu_collectives"):
        parallel.initialize("localhost:1234", 2, 1, cpu_collectives="nccl")
    with pytest.raises(ValueError, match="go together"):
        parallel.initialize("localhost:1234")
    if not dist.is_mpi_available():
        with pytest.raises(ValueError, match="MPI"):
            parallel.initialize("localhost:1234", 2, 1, cpu_collectives="mpi")


@pytest.fixture(scope="module")
def sc_beam():
    return _numpy_beam(42, (4000,), (1.7e-4, 2e-7, 1.7e-4, 2e-7, 1e-5, 1e-3), total_charge=1e-9)


def _port_kick(axis=None, effect_length=0.25):
    return ctt.SpaceChargeKick(torch.tensor(effect_length, dtype=F64), grid_shape=GRID,
                               particle_axis=axis, device=CPU)


def test_one_rank_particle_axis_kick_matches_jax(mesh, sc_beam):
    """The kick over a one-rank particle axis (both all-reduces issued)
    equals the JAX package's unsharded kick and its shard_map kick over 8
    devices, to rtol 1e-9 / atol 1e-14."""
    beam = beam_to_torch(sc_beam)
    with parallel.active_mesh(mesh), collectives.recording() as lines:
        kicked = _port_kick("particles").track(beam).particles.numpy()
    assert lines == ["all-reduce f64[4,3,1] replica_groups={{0}}",
                     "all-reduce f64[1,8,8,8] replica_groups={{0}}"]
    kick = ct.SpaceChargeKick(jnp.asarray(0.25, jnp.float64), grid_shape=GRID)
    expected = np.asarray(jax.jit(lambda k, b: k.track(b).particles)(kick, sc_beam))
    np.testing.assert_allclose(kicked, expected, rtol=1e-9, atol=1e-14)

    jax_mesh = Mesh(np.array(jax.devices()), ("particles",))
    sharded = ct.SpaceChargeKick(jnp.asarray(0.25, jnp.float64), grid_shape=GRID,
                                 particle_axis="particles")

    @jax.jit
    @partial(shard_map, mesh=jax_mesh, in_specs=(P("particles", None), P("particles")),
             out_specs=P("particles", None))
    def kicked_shard(particles, charges):
        local = ct.ParticleBeam(particles=particles, energy=sc_beam.energy,
                                particle_charges=charges)
        return sharded.track(local).particles

    np.testing.assert_allclose(
        kicked, np.asarray(kicked_shard(sc_beam.particles, sc_beam.particle_charges)),
        rtol=1e-9, atol=1e-14,
    )


def test_one_rank_particle_axis_kick_gradient_matches_jax(mesh, sc_beam):
    """value_and_grad of mean(px^2 + py^2) after a drift and the kick, by
    the drift's length (through both all-reduces' backward) and the kick's,
    against ``jax.value_and_grad`` (loss 1e-10, gradients 1e-8)."""
    beam = beam_to_torch(sc_beam)
    lengths = torch.tensor([0.25, 0.5], dtype=F64, requires_grad=True)
    with parallel.active_mesh(mesh), collectives.recording() as lines:
        segment = ctt.Segment([ctt.Drift(lengths[0], device=CPU), _port_kick("particles")])
        segment.elements[1].effect_length = lengths[1]
        out = segment.track(beam).particles
        loss = torch.mean(out[..., 1] ** 2 + out[..., 3] ** 2)
        (grads,) = torch.autograd.grad(loss, lengths)
    assert len(lines) == 4  # two forward, two backward

    def jax_loss(values):
        segment = ct.Segment([
            ct.Drift(values[0]), ct.SpaceChargeKick(values[1], grid_shape=GRID)
        ])
        out = segment.track(sc_beam).particles
        return jnp.mean(jnp.square(out[..., 1]) + jnp.square(out[..., 3]))

    value, expected = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray([0.25, 0.5]))
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-10)
    np.testing.assert_allclose(grads.numpy(), np.asarray(expected), rtol=1e-8)


def test_kick_axis_name_needs_an_active_mesh(sc_beam):
    with pytest.raises(RuntimeError, match="active_mesh"):
        _port_kick("particles").track(beam_to_torch(sc_beam))
    with parallel.active_mesh(parallel.make_mesh({"particles": 1})):
        with pytest.raises(ValueError, match="not among"):
            _port_kick("hosts").track(beam_to_torch(sc_beam))


def test_kick_clone_keeps_its_particle_axis():
    kick = _port_kick(("hosts", "devices"))
    assert kick.clone().particle_axis == ("hosts", "devices")
    assert _port_kick().particle_axis is None


def test_all_reduce_is_differentiable(mesh):
    value = torch.tensor([1.0, 2.0], dtype=F64, requires_grad=True)
    with parallel.active_mesh(mesh):
        summed = collectives.all_reduce(value * 3.0, "particles")
        gathered = collectives.all_gather(value, "particles")
        broadcast = collectives.broadcast(value, "particles")
    (grad,) = torch.autograd.grad(summed.sum() + gathered.sum(), value)
    np.testing.assert_array_equal(grad.numpy(), [4.0, 4.0])
    assert tuple(gathered.shape) == (2,) and not broadcast.requires_grad


# ---------------------------------------------------------------------------
# BatchedLatticeEnv against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env_beam():
    return _numpy_beam(5, (256,), TRANSVERSE)


def _jax_env(beam, **kw):
    return jax_parallel.BatchedLatticeEnv(jax_fodo(), beam, tunables=[("q1", "k1"), ("q2", "k1")],
                                          **kw)


def _port_env(beam, **kw):
    return parallel.BatchedLatticeEnv(fodo(), beam_to_torch(beam),
                                      tunables=[("q1", "k1"), ("q2", "k1")], **kw)


SETTINGS = np.stack([np.linspace(2.0, 8.0, 32), np.linspace(-8.0, -2.0, 32)], axis=-1)


@pytest.mark.parametrize("moments_only", [False, True])
def test_env_step_matches_jax(env_beam, moments_only):
    env = _port_env(env_beam, moments_only=moments_only)
    outgoing, readings, reward = env.step(torch.tensor(SETTINGS))
    jax_out, _, jax_reward = jax.jit(_jax_env(env_beam, moments_only=moments_only).step)(
        jnp.asarray(SETTINGS)
    )
    assert readings == {}
    assert isinstance(outgoing, ctt.ParameterBeam if moments_only else ctt.ParticleBeam)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=1e-10)
    np.testing.assert_allclose(outgoing.sigma_y.numpy(), np.asarray(jax_out.sigma_y), rtol=1e-10)
    np.testing.assert_allclose(env.reward(torch.tensor(SETTINGS)).numpy(), reward.numpy(),
                               rtol=0, atol=0)
    # The lattice keeps its own settings after the step.
    assert env.segment.q1.k1.item() == 5.0 and env.segment.q2.k1.item() == -4.0


def test_env_readings_match_jax(env_beam):
    """``tests/test_parallel.py:176-195``: a BPM's reading per instance."""
    jax_segment = ct.Segment(
        [ct.Drift(jnp.asarray(1.0, jnp.float64), name="d1"),
         ct.Quadrupole(jnp.asarray(0.3, jnp.float64), k1=jnp.asarray(5.0, jnp.float64), name="q1"),
         ct.BPM(is_active=True, name="bpm1")],
        name="diag",
    )
    settings = np.linspace(-5, 5, 4)[:, None]
    jax_env = jax_parallel.BatchedLatticeEnv(jax_segment, env_beam, tunables=[("q1", "k1")])
    _, jax_readings, jax_reward = jax.jit(jax_env.step)(jnp.asarray(settings))
    env = parallel.BatchedLatticeEnv(segment_to_torch(jax_segment), beam_to_torch(env_beam),
                                     tunables=[("q1", "k1")])
    _, readings, reward = env.step(torch.tensor(settings))
    assert tuple(reward.shape) == (4,) and tuple(readings["bpm1"].shape) == (4, 2)
    np.testing.assert_allclose(readings["bpm1"].numpy(), np.asarray(jax_readings["bpm1"]),
                               rtol=1e-10, atol=1e-20)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=1e-10)


def test_env_grad_steps_match_jax(env_beam):
    """Five grad steps in lockstep equal the JAX env's to rtol 1e-10."""
    env, jax_env = _port_env(env_beam), _jax_env(env_beam)
    step = jax.jit(jax_env.grad_step)
    settings, jax_settings = torch.tensor(SETTINGS), jnp.asarray(SETTINGS)
    for _ in range(5):
        settings, reward = env.grad_step(settings, 1e4)
        jax_settings, jax_reward = step(jax_settings, 1e4)
        np.testing.assert_allclose(settings.numpy(), np.asarray(jax_settings), rtol=1e-10)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jax_reward), rtol=1e-10)
    assert not settings.requires_grad and not reward.requires_grad


def test_env_training_raises_the_mean_reward(env_beam):
    """``tests/test_parallel.py:139-174``: 100 grad steps of 32 instances
    raise the batch's mean reward, in both packages alike."""
    env = _port_env(env_beam)
    settings = torch.tensor(SETTINGS)
    initial = env.reward(settings)
    for _ in range(100):
        settings, reward = env.grad_step(settings, 1e4)
    assert reward.mean().item() > initial.mean().item()


def test_env_refuses_what_it_cannot_tune(env_beam):
    with pytest.raises(ValueError, match="not a parameter"):
        parallel.BatchedLatticeEnv(fodo(), beam_to_torch(env_beam), tunables=[("q1", "name")])
    env = _port_env(env_beam)
    assert env.num_tunables == 2
    with pytest.raises(ValueError, match="columns"):
        env.step(torch.zeros(4, 3, dtype=F64))


def test_env_tunes_a_cavity_that_starts_off():
    """Tuned by assignment, a cavity at zero voltage reacts to the tuned
    voltage (it stops fusing) and is off again after the step."""
    kw = {"dtype": F64, "device": CPU}
    segment = ctt.Segment([ctt.Drift(0.5, **kw), ctt.Cavity(1.0, voltage=0.0, phase=0.0,
                                                            frequency=1.3e9, name="c1", **kw)])
    beam = ctt.ParticleBeam.from_parameters(num_particles=64, energy=1e8,
                                            generator=torch.Generator().manual_seed(0), **kw)
    env = parallel.BatchedLatticeEnv(segment, beam, [("c1", "voltage")],
                                     objective=lambda out, _: out.energy)
    reward = env.reward(torch.tensor([[0.0], [1e6]], dtype=F64))
    assert reward[1].item() > reward[0].item() == 1e8
    assert segment.c1.is_skippable


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def _spec_of(placements, ndim, names):
    """The PartitionSpec-like tuple that port placements describe."""
    from torch.distributed.tensor import Shard

    spec = [None] * ndim
    for name, placement in zip(names, placements):
        if isinstance(placement, Shard):
            spec[placement.dim] = name
    return tuple(spec)


@pytest.mark.parametrize("axes", [("instances", None), (None, "particles"),
                                  ("instances", "particles")])
def test_beam_shardings_match_jax(axes):
    """The same field-by-field layout as the JAX package's beam_shardings,
    on a vectorised ParticleBeam."""
    instance_axis, particle_axis = axes
    beam = _numpy_beam(1, (4, 32), TRANSVERSE)
    jax_mesh = jax_parallel.make_mesh({"instances": 4, "particles": 2})
    jax_specs = jax_parallel.beam_shardings(beam, jax_mesh, instance_axis, particle_axis)
    mesh = parallel.make_mesh({"instances": 1, "particles": 1})
    placements = parallel.beam_shardings(beam_to_torch(beam), mesh, instance_axis, particle_axis)
    for field in ("particles", "particle_charges", "survival_probabilities", "energy", "s"):
        ndim = np.ndim(getattr(beam, field))
        jax_spec = tuple(getattr(jax_specs, field).spec) + (None,) * ndim
        assert _spec_of(placements[field], ndim, mesh.mesh_dim_names) == jax_spec[:ndim], field
    assert _spec_of(placements["species.mass_eV"], 0, mesh.mesh_dim_names) == ()


def test_shard_helpers_on_one_rank():
    mesh = parallel.make_mesh({"instances": 1, "particles": 1})
    beam = beam_to_torch(_numpy_beam(1, (4, 32), TRANSVERSE))
    local = parallel.shard_beam(beam, mesh, instance_axis="instances", particle_axis="particles")
    assert torch.equal(local.particles, beam.particles)
    with pytest.raises(ValueError, match="no particle axis"):
        parallel.shard_beam(beam.as_parameter_beam(), mesh, particle_axis="particles")
    array = parallel.make_process_local_array(np.ones((4, 3)), mesh, ("instances", None))
    assert tuple(array.shape) == (4, 3)
    segment = fodo()
    segment.q1.k1 = torch.tensor(2.0, dtype=F64)
    copy = parallel.replicate(segment, mesh)
    assert copy is not segment and copy.q1.k1.item() == 2.0
    global_beam = parallel.process_local_beam(beam, mesh, instance_axis="instances")
    assert tuple(global_beam.particles.shape) == (4, 32, 7)


def test_shard_segment_cuts_only_instance_parameters():
    """An unvectorised lattice keeps its misalignments (length 2, not two
    instances); a vectorised one is cut where its leading length is the
    instance count; parameters that disagree on it raise."""
    mesh = parallel.make_mesh({"instances": 1})
    segment = fodo()
    assert sharding._num_instances(segment) is None
    assert parallel.shard_segment(segment, mesh, "instances") == segment
    quad = ctt.Quadrupole(0.3, k1=torch.linspace(-1, 1, 2, dtype=F64),
                          misalignment=torch.zeros(2, 2, dtype=F64), device=CPU)
    assert sharding._num_instances(ctt.Segment([quad])) == 2
    quad.k1 = torch.zeros(3, dtype=F64)
    with pytest.raises(ValueError, match="disagree"):
        sharding._num_instances(ctt.Segment([quad]))


# ---------------------------------------------------------------------------
# The collective audit
# ---------------------------------------------------------------------------


HYBRID = types.SimpleNamespace(mesh=torch.arange(4).reshape(2, 2),
                               mesh_dim_names=("hosts", "devices"))


@pytest.mark.parametrize(
    "groups, crosses",
    [("{{0,1},{2,3}}", {"hosts": False, "devices": True}),
     ("{{0,2},{1,3}}", {"hosts": True, "devices": False}),
     ("{{0,1,2,3}}", {"hosts": True, "devices": True})],
)
def test_parse_collectives_matches_the_jax_parser(groups, crosses):
    """A recorded line and the HLO line of the same collective give the
    same bytes and axis crossings (a 2 x 2 hybrid mesh)."""
    (op,) = comm_audit.parse_collectives(f"all-reduce f64[4,3,1] replica_groups={groups}", HYBRID)
    jax_mesh = jax_parallel.make_hybrid_mesh({"devices": 4}, {"hosts": 2})
    jax_mesh = Mesh(np.asarray(jax_mesh.devices).reshape(-1)[:4].reshape(2, 2),
                    ("hosts", "devices"))
    (jax_op,) = jax_parse_collectives(
        f"  %ar = f64[4,3,1]{{2,1,0}} all-reduce(%x), replica_groups={groups}", jax_mesh
    )
    assert op.crosses == crosses == jax_op.crosses
    assert op.output_bytes == jax_op.output_bytes == 96
    assert op.groups == jax_op.groups


def test_parse_collectives_reads_back_recorded_lines(mesh, sc_beam):
    """A report of the recorded kick (its two all-reduces) and of its own
    text agree; other lines are skipped."""
    beam = beam_to_torch(sc_beam)
    report = parallel.collective_report(lambda: _port_kick("particles").track(beam), mesh,
                                        dcn_axes=("particles",))
    text = "\n".join(op.line for op in report.ops) + "\nnot a collective"
    again = parallel.collective_report(text, mesh, dcn_axes=("particles",))
    assert [op.line for op in again.ops] == [op.line for op in report.ops]
    assert report.total_bytes == 4 * 3 * 8 + 8**3 * 8
    assert report.dcn_bytes == report.bytes_crossing("particles") == 0  # one rank
    report = comm_audit.CollectiveReport(
        comm_audit.parse_collectives("all-reduce f32[4096] replica_groups={{0,2},{1,3}}", HYBRID),
        ("hosts",),
    )
    assert report.dcn_bytes == report.bytes_crossing("hosts") == 4 * 4096
    assert report.bytes_crossing("devices") == 0


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_subcell():
    segment = jax_ares_ea_subcell(dtype=jnp.float64)
    segment.AREAMQZM1.k1 = jnp.asarray(12.5, jnp.float64)
    segment.AREAMQZM3.k1 = jnp.asarray(-3.25, jnp.float64)
    segment.AREAMCHM1.angle = jnp.asarray(2e-4, jnp.float64)
    return segment


def test_jax_checkpoint_loads_into_the_port(tmp_path, jax_subcell, env_beam):
    """A ``.npz`` written by the JAX package for the ARES EA subcell with
    set magnets loads into the port's fresh subcell and tracks to the JAX
    package's values."""
    path = tmp_path / "subcell.npz"
    jax_checkpoint.save(jax_subcell, str(path))
    template = ares_ea_subcell(F64, device=CPU)
    loaded = checkpoint.load(template, str(path))
    assert loaded.AREAMQZM1.k1.item() == 12.5 and template.AREAMQZM1.k1.item() == 10.0
    expected = jax.jit(lambda s, b: s.track(b).particles)(jax_subcell, env_beam)
    np.testing.assert_allclose(loaded.track(beam_to_torch(env_beam)).particles.numpy(),
                               np.asarray(expected), rtol=1e-10, atol=1e-20)


def test_port_checkpoint_loads_into_jax(tmp_path, env_beam):
    """The other way: the port's file, in the JAX package's layout."""
    segment = ares_ea_subcell(F64, device=CPU)
    segment.AREAMQZM2.k1 = torch.tensor(-7.75, dtype=F64)
    path = tmp_path / "port.npz"
    checkpoint.save(segment, str(path))
    loaded = jax_checkpoint.load(jax_ares_ea_subcell(dtype=jnp.float64), str(path))
    assert float(loaded.AREAMQZM2.k1) == -7.75
    state = checkpoint.state_dict(segment)
    assert state["elements.4.k1"] == -7.75 and "elements.4.misalignment" in state


def test_beam_checkpoints_cross_both_ways(tmp_path, env_beam):
    jax_checkpoint.save(env_beam, str(tmp_path / "beam.npz"))
    template = beam_to_torch(_numpy_beam(9, (256,), TRANSVERSE))
    loaded = checkpoint.load(template, str(tmp_path / "beam.npz"))
    np.testing.assert_array_equal(loaded.particles.numpy(), np.asarray(env_beam.particles))
    loaded.particles = loaded.particles * 2.0
    checkpoint.save({"beam": loaded, "k1s": torch.tensor([1.0, 2.0], dtype=F64)},
                    str(tmp_path / "state.npz"))
    back = jax_checkpoint.load({"beam": env_beam, "k1s": jnp.zeros(2)}, str(tmp_path / "state.npz"))
    np.testing.assert_array_equal(np.asarray(back["beam"].particles),
                                  2.0 * np.asarray(env_beam.particles))
    np.testing.assert_array_equal(np.asarray(back["k1s"]), [1.0, 2.0])


def test_load_state_dict_keeps_what_is_missing():
    segment = fodo()
    loaded = checkpoint.load_state_dict(segment, {"elements.1.k1": np.asarray(7.0),
                                                  "not.a.path": np.asarray(1.0)})
    assert loaded.q1.k1.item() == 7.0 and loaded.q2.k1.item() == -4.0
    assert segment.q1.k1.item() == 5.0


def test_sharded_checkpoint_on_one_rank(tmp_path, mesh):
    beam = beam_to_torch(_numpy_beam(3, (64,), TRANSVERSE))
    global_beam = parallel.process_local_beam(beam, mesh, particle_axis="particles")
    state = {"beam": global_beam, "segment": fodo()}
    checkpoint.save_sharded(state, str(tmp_path / "ckpt"))
    template = {"beam": parallel.process_local_beam(beam_to_torch(_numpy_beam(4, (64,), TRANSVERSE)),
                                                     mesh, particle_axis="particles"),
                "segment": fodo()}
    template["segment"].q1.k1 = torch.tensor(0.0, dtype=F64)
    restored = checkpoint.load_sharded(template, str(tmp_path / "ckpt"))
    assert torch.equal(restored["beam"].particles.to_local(), beam.particles)
    assert restored["segment"].q1.k1.item() == 5.0 and restored["segment"].q1.name == "q1"
    with pytest.raises(FileExistsError):
        checkpoint.save_sharded(state, str(tmp_path / "ckpt"))
    checkpoint.save_sharded(state, str(tmp_path / "ckpt"), overwrite=True)
    assert os.path.isdir(tmp_path / "ckpt")
