"""One rank of the port's multi-process CPU tests (``test_torch_distributed.py``).

Started as ``python torch_parallel_worker.py <job>:<world size>[,...]
<rank> <processes> <directory>``: reads the inputs that the test wrote with
numpy into ``<directory>/inputs.npz`` (the JAX package's arrays) and, for
each job in turn, joins a gloo process group of the job's world size
through the file store ``<directory>/store_<job>``, runs the job's checks
on its own block and writes what it computed to
``<directory>/<job>_rank<rank>.npz``; the test holds those against the JAX
package. It imports torch and the port only, and builds every tensor in
float64 explicitly.

Jobs:

- ``flat`` (2 ranks): instance-axis tracking (linear and second order),
  the particle-sharded space-charge kick and its gradients (also with a
  plain in-place all-reduce in place of the port's, which must lose the
  other rank's terms), ``torch.func.jvp`` and ``vmap`` through the sharded
  32^3 kick, ``BatchedLatticeEnv`` over the instance axis, the
  collective audit of its grad step, ``all_gather``, ``replicate`` and a
  sharded checkpoint.
- ``hybrid`` (4 ranks): a 2 x 2 hybrid mesh, the kick with
  ``particle_axis=("hosts", "devices")``, and the audit's axis attribution.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.parallel import (
    BatchedLatticeEnv,
    active_mesh,
    collective_report,
    initialize,
    make_hybrid_mesh,
    make_mesh,
    process_local_beam,
    replicate,
    shard_beam,
    shard_segment,
)
from cheetah_tpu_torch.parallel import collectives
from cheetah_tpu_torch.utils import checkpoint

F64 = torch.float64
CPU = "cpu"
GRID = (8, 8, 8)


def fodo() -> ctt.Segment:
    """The FODO cell of ``tests/test_parallel.py``."""
    kw = {"dtype": F64, "device": CPU}
    return ctt.Segment(
        [
            ctt.Drift(1.0, name="d1", **kw),
            ctt.Quadrupole(0.3, k1=5.0, name="q1", **kw),
            ctt.Drift(0.5, name="d2", **kw),
            ctt.Quadrupole(0.3, k1=-4.0, name="q2", **kw),
            ctt.Drift(1.0, name="d3", **kw),
        ],
        name="fodo",
    )


def beam_from(inputs, prefix: str) -> ctt.ParticleBeam:
    return interop.particle_beam_from_numpy(
        inputs[f"{prefix}_particles"], inputs[f"{prefix}_energy"],
        inputs[f"{prefix}_charges"], inputs[f"{prefix}_survival"], device=CPU,
    )


def kick_loss(beam, effect_length, drift_length, particle_axis, num_particles):
    """This rank's share of mean(px^2 + py^2) over all particles after
    Drift(drift_length), the 8^3 kick and Drift(0.25)."""
    segment = ctt.Segment([
        ctt.Drift(drift_length, device=CPU),
        ctt.SpaceChargeKick(effect_length, grid_shape=GRID, particle_axis=particle_axis,
                            device=CPU),
        ctt.Drift(torch.tensor(0.25, dtype=F64), device=CPU),
    ])
    out = segment.track(beam).particles
    return torch.sum(out[..., 1] ** 2 + out[..., 3] ** 2) / num_particles


def kick_results(beam, particle_axis, num_particles) -> dict:
    """The kicked particles, the loss and its gradients by the kick's
    effect length and the first drift's length, by the convention of
    ``SpaceChargeKick``: backward of the rank's own share, then an
    all-reduce of the replicated parameters' gradients."""
    effect_length = torch.tensor(0.5, dtype=F64, requires_grad=True)
    drift_length = torch.tensor(0.25, dtype=F64, requires_grad=True)
    kick = ctt.SpaceChargeKick(torch.tensor(0.25, dtype=F64), grid_shape=GRID,
                               particle_axis=particle_axis, device=CPU)
    local = kick_loss(beam, effect_length, drift_length, particle_axis, num_particles)
    grads = torch.autograd.grad(local, (effect_length, drift_length))
    grads = collectives.all_reduce(torch.stack(grads), particle_axis)
    return {
        "kicked": kick.track(beam).particles.numpy(),
        "loss": collectives.all_reduce(local.detach(), particle_axis).numpy(),
        "grad_effect_length": grads[0].numpy(),
        "grad_drift_length": grads[1].numpy(),
    }


FUNC_GRID = (32, 32, 32)


def func_transform_results(beam, particle_axis, num_particles) -> dict:
    """``torch.func.jvp`` and ``torch.func.vmap`` of the 32^3 kick's loss,
    mean(px^2) over all particles, as functions of the particles: sharded
    over ``particle_axis`` (this rank's rows, the loss all-reduced) and in
    one process on all rows (``particle_axis=None``, the same on every
    rank). The direction and the second point of the vmap are made from
    the particles, so both runs see the same rows."""

    def loss_function(axis, count):
        kick = ctt.SpaceChargeKick(torch.tensor(0.25, dtype=F64), grid_shape=FUNC_GRID,
                                   particle_axis=axis, device=CPU)

        def loss(particles):
            kicked = kick.track(ctt.ParticleBeam(particles, beam.energy,
                                                 particle_charges=charges)).particles
            share = torch.sum(kicked[..., 1] ** 2) / count
            return share if axis is None else collectives.all_reduce(share, axis)

        return loss

    def transforms(particles, axis):
        direction = particles * torch.linspace(0.5, 1.5, 7, dtype=F64)
        direction[..., 6] = 0.0
        loss = loss_function(axis, num_particles)
        value, tangent = torch.func.jvp(loss, (particles,), (direction,))
        mapped = torch.func.vmap(loss)(torch.stack([particles, particles * 1.1]))
        return {"value": value, "jvp": tangent, "vmap": mapped}

    charges = beam.particle_charges
    sharded = transforms(beam.particles, particle_axis)
    full = collectives.all_gather(beam.particles, particle_axis)
    charges = collectives.all_gather(beam.particle_charges, particle_axis)
    one_process = transforms(full, None)
    return {
        **{f"func_{name}": value.detach().numpy() for name, value in sharded.items()},
        **{f"func_{name}_one_process": value.detach().numpy()
           for name, value in one_process.items()},
    }


class _PlainAllReduce(torch.autograd.Function):
    """``torch.distributed.all_reduce`` as code that forgets autograd would
    call it: in place, its backward the identity."""

    @staticmethod
    def forward(ctx, tensor, group, groups):
        summed = tensor.clone()
        dist.all_reduce(summed, group=group)
        return summed

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def plain_all_reduce_gradient(beam, particle_axis, num_particles) -> np.ndarray:
    """The drift-length gradient with the kick's all-reduces made plain."""
    differentiable = collectives._AllReduce
    collectives._AllReduce = _PlainAllReduce
    try:
        drift_length = torch.tensor(0.25, dtype=F64, requires_grad=True)
        local = kick_loss(beam, torch.tensor(0.5, dtype=F64), drift_length, particle_axis,
                             num_particles)
        (grad,) = torch.autograd.grad(local, drift_length)
    finally:
        collectives._AllReduce = differentiable
    return collectives.all_reduce(grad, particle_axis).numpy()


def job_flat(inputs, rank: int) -> dict:
    results = {}
    instances = make_mesh({"instances": 2})
    particles = make_mesh({"particles": 2})

    # Instance axis: the vectorised beam and lattice cut to this rank's rows.
    beam = beam_from(inputs, "inst")
    for method in ("linear", "second_order"):
        segment = fodo()
        segment.q1.tracking_method = method
        segment.q1.k1 = torch.tensor(inputs["inst_k1"])
        local_segment = shard_segment(segment, instances, "instances")
        local_beam = shard_beam(beam, instances, instance_axis="instances")
        results[f"sigma_x_{method}"] = local_segment.track(local_beam).sigma_x.numpy()
        with active_mesh(instances):
            results[f"gathered_{method}"] = collectives.all_gather(
                local_segment.track(local_beam).sigma_x, "instances"
            ).numpy()

    # Particle axis: the kick on this rank's particles.
    sc_beam = beam_from(inputs, "sc")
    count = sc_beam.num_particles
    with active_mesh(particles):
        local = shard_beam(sc_beam, particles, particle_axis="particles")
        results.update(kick_results(local, "particles", count))
        results["grad_drift_length_plain"] = plain_all_reduce_gradient(local, "particles", count)
        results.update(func_transform_results(local, "particles", count))
    # The same through a ProcessGroup instead of a name.
    group = particles.get_group("particles")
    results["kicked_by_group"] = ctt.SpaceChargeKick(
        torch.tensor(0.25, dtype=F64), grid_shape=GRID, particle_axis=group, device=CPU
    ).track(local).particles.numpy()

    # The env over the instance axis: this rank's rows of the settings.
    env_beam = beam_from(inputs, "env")
    env = BatchedLatticeEnv(fodo(), env_beam, tunables=[("q1", "k1"), ("q2", "k1")])
    settings = torch.tensor(inputs["env_settings"]).chunk(2)[rank]
    trajectory = []
    for _ in range(5):
        settings, reward = env.grad_step(settings, 1e4)
        trajectory.append(settings.numpy())
    results["env_settings_after"] = np.stack(trajectory)
    results["env_reward"] = reward.numpy()

    def audited_step():
        new, reward = env.grad_step(settings, 1e4)
        return collectives.all_reduce(reward.sum(), "instances")

    report = collective_report(audited_step, instances, dcn_axes=("instances",))
    results["audit_lines"] = np.array([op.line for op in report.ops])
    results["audit_dcn_bytes"] = np.array(report.dcn_bytes)

    # Replicate rank 0's lattice; a sharded checkpoint of the local beam.
    segment = fodo()
    segment.q1.k1 = torch.tensor(float(rank) + 1.0, dtype=F64)
    results["replicated_k1"] = replicate(segment, instances).q1.k1.numpy()
    directory = os.path.join(sys.argv[4], "beam_checkpoint")
    global_beam = process_local_beam(local, particles, particle_axis="particles")
    checkpoint.save_sharded(global_beam, directory)
    template = process_local_beam(
        ctt.ParticleBeam(torch.zeros_like(local.particles), local.energy, device=CPU),
        particles, particle_axis="particles",
    )
    restored = checkpoint.load_sharded(template, directory)
    results["restored_local"] = restored.particles.to_local().numpy()
    results["restored_global_shape"] = np.array(restored.particles.shape)
    dist.barrier()
    try:
        checkpoint.save_sharded(global_beam, directory)
        results["refused_overwrite"] = np.array(False)
    except FileExistsError:
        results["refused_overwrite"] = np.array(True)
    return results


def job_hybrid(inputs, rank: int) -> dict:
    results = {}
    # Two nodes of two ranks each (LOCAL_WORLD_SIZE=2, as torchrun sets it).
    mesh = make_hybrid_mesh({"devices": 2}, {"hosts": 2})
    results["mesh_ranks"] = mesh.mesh.numpy()
    default = make_hybrid_mesh()
    results["default_mesh"] = np.array([*default.mesh_dim_names, *map(str, default.mesh.shape)])
    try:
        make_hybrid_mesh({"devices": 4}, {"hosts": 1})
        results["refused_mismatch"] = np.array(False)
    except ValueError:
        results["refused_mismatch"] = np.array(True)
    axes = ("hosts", "devices")
    sc_beam = beam_from(inputs, "sc")
    with active_mesh(mesh):
        local = shard_beam(sc_beam, mesh, particle_axis=axes)
        results.update(kick_results(local, axes, sc_beam.num_particles))

    def kick_step():
        effect_length = torch.tensor(0.5, dtype=F64, requires_grad=True)
        drift_length = torch.tensor(0.25, dtype=F64, requires_grad=True)
        loss = kick_loss(local, effect_length, drift_length, axes, sc_beam.num_particles)
        torch.autograd.grad(loss, (effect_length, drift_length))

    report = collective_report(kick_step, mesh)
    results["kick_lines"] = np.array([op.line for op in report.ops])
    results["kick_dcn_bytes"] = np.array(report.dcn_bytes)
    results["kick_devices_bytes"] = np.array(report.bytes_crossing("devices"))
    within = collective_report(
        lambda: collectives.all_reduce(torch.ones(4, dtype=F64), "devices"), mesh
    )
    results["devices_only_dcn_bytes"] = np.array(within.dcn_bytes)
    results["devices_only_bytes"] = np.array(within.bytes_crossing("devices"))

    # The ARES EA env step's gradient, settings over hosts x devices, with
    # the mean loss all-reduced: readout-sized traffic across hosts.
    segment = ctt.lattices.ares_ea_subcell(F64, device=CPU)
    env = BatchedLatticeEnv(segment, beam_from(inputs, "ares"), tunables=[("AREAMQZM1", "k1")])
    settings = shard_beam_rows(torch.tensor(inputs["ares_settings"]), mesh, axes)

    def env_step():
        settings_grad = settings.detach().requires_grad_()
        outgoing = env.step(settings_grad)[0]
        local_loss = torch.sum(outgoing.sigma_x ** 2 + outgoing.sigma_y ** 2) / 64
        torch.autograd.grad(local_loss, settings_grad)
        return collectives.all_reduce(local_loss.detach(), axes)

    report = collective_report(env_step, mesh)
    results["env_dcn_bytes"] = np.array(report.dcn_bytes)
    results["env_ops"] = np.array(len(report.ops))
    return results


def shard_beam_rows(tensor: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's rows of ``tensor`` along the mesh axes ``axes``."""
    index, size = collectives.axis_index(mesh, axes)
    return tensor.chunk(size)[index]


JOBS = {"flat": job_flat, "hybrid": job_hybrid}


def main() -> None:
    """Run the jobs of ``<job>:<world size>[,...]`` in turn, each on a
    process group of its own over the first ``<world size>`` ranks; a rank
    past a job's world size stops there. One launch of processes serves
    every job, so the test starts each process, and imports torch, once."""
    jobs, rank, directory = sys.argv[1], int(sys.argv[2]), sys.argv[4]
    inputs = dict(np.load(os.path.join(directory, "inputs.npz")))
    for spec in jobs.split(","):
        job, world_size = spec.split(":")
        if rank >= int(world_size):
            break
        initialize(f"file://{os.path.join(directory, f'store_{job}')}", int(world_size), rank)
        results = JOBS[job](inputs, rank)
        np.savez(os.path.join(directory, f"{job}_rank{rank}.npz"), **results)
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
