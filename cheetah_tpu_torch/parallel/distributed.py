"""Multi-process execution: joining a cluster, meshes over nodes, global
views of local blocks (counterpart of ``cheetah_tpu/parallel/distributed.py``).

One process per rank, one card per process, as ``torchrun`` starts them:

1. Every process calls :func:`initialize` once, before any collective: a
   bare call joins the cluster that the environment describes (``torchrun``'s
   ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``, or SLURM's variables);
   explicit arguments go to ``torch.distributed.init_process_group``. CUDA
   tensors ride NCCL, CPU tensors gloo (or MPI).
2. :func:`make_hybrid_mesh` builds a mesh whose leading (DCN) axes span
   nodes and whose trailing (ICI) axes span the ranks of one node, so that
   the heavy collective (the space-charge grid's all-reduce over the
   particle axis) stays inside a node (NVLink) and only the instance
   axis's readout-sized traffic crosses the network.
3. :func:`make_process_local_array` and :func:`process_local_beam` give the
   global view (a ``DTensor``) of what each rank holds, without gathering
   it on one rank, for checkpoints (:func:`cheetah_tpu_torch.utils.checkpoint.save_sharded`)
   and inspection; tracking runs on the local tensors.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from cheetah_tpu_torch.parallel import collectives
from cheetah_tpu_torch.parallel.sharding import _beam_dims, _placements, beam_shardings, make_mesh
from cheetah_tpu_torch.utils import tree


def _environment_world_size() -> int:
    """The number of workers the environment describes (1 when none)."""
    for key in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            size = int(os.environ.get(key, "1"))
        except ValueError:
            continue
        if size > 1:
            return size
    return 1


def _backend(cpu_collectives: str) -> str:
    if cpu_collectives == "mpi" and not dist.is_mpi_available():
        raise ValueError("cpu_collectives='mpi' needs a torch built with MPI.")
    if torch.cuda.is_available() and dist.is_nccl_available():
        return f"cpu:{cpu_collectives},cuda:nccl"
    return cpu_collectives


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: int | Sequence[int] | None = None,
    cpu_collectives: str = "gloo",
) -> None:
    """Join (or bootstrap) a multi-process cluster; idempotent.

    :param coordinator_address: ``"host:port"`` of rank 0's store, or an
        ``init_method`` URL (``"tcp://host:port"``, ``"file:///path"``).
        ``None`` takes the cluster from the environment.
    :param num_processes: Total number of processes (the world size).
    :param process_id: This process's rank in ``[0, num_processes)``.
    :param local_device_ids: The card of this process (an int or a
        sequence of one); defaults to ``LOCAL_RANK`` where set. One card per
        process.
    :param cpu_collectives: The backend of CPU tensors, ``"gloo"`` or
        ``"mpi"``; CUDA tensors take NCCL where a card is present.

    A bare call on a plain single process (no cluster in the environment) is
    a no-op. Where the environment shows more than one worker and the
    cluster cannot be joined, the error propagates: a worker of several
    that went on alone would compute wrong results.
    """
    if dist.is_initialized():
        return
    if cpu_collectives not in ("gloo", "mpi"):
        raise ValueError(f"Unknown cpu_collectives {cpu_collectives!r}; must be 'gloo' or 'mpi'.")
    backend = _backend(cpu_collectives)
    if local_device_ids is None and "LOCAL_RANK" in os.environ:
        local_device_ids = int(os.environ["LOCAL_RANK"])
    if local_device_ids is not None and torch.cuda.is_available():
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        if len(ids) != 1:
            raise ValueError(f"One card per process; local_device_ids {ids} name {len(ids)}.")
        torch.cuda.set_device(ids[0])

    if coordinator_address is None and num_processes is None and process_id is None:
        try:
            if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
                dist.init_process_group(backend, init_method="env://")
            elif "SLURM_PROCID" in os.environ and "MASTER_ADDR" in os.environ:
                dist.init_process_group(
                    backend,
                    init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}",
                    world_size=int(os.environ.get("SLURM_NTASKS", "1")),
                    rank=int(os.environ["SLURM_PROCID"]),
                )
            elif _environment_world_size() > 1:
                raise RuntimeError(
                    f"The environment shows {_environment_world_size()} workers but names "
                    "no rendezvous (MASTER_ADDR and RANK or SLURM_PROCID)."
                )
        except (ValueError, RuntimeError):
            if _environment_world_size() > 1:
                raise
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("coordinator_address, num_processes and process_id go together.")
    init_method = (
        coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    )
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(minutes=10),
    )


def make_hybrid_mesh(
    ici_axes: dict[str, int] | None = None,
    dcn_axes: dict[str, int] | None = None,
    devices: Sequence[int] | None = None,
) -> DeviceMesh:
    """Build a DCN x ICI mesh for multi-node execution.

    The DCN axes (named first) span nodes; the ICI axes (last) span the
    ranks of one node, so collectives over them stay inside a node. A node
    is ``LOCAL_WORLD_SIZE`` consecutive ranks, as ``torchrun`` numbers
    them, so the row-major layout of the global ranks is that order. On one
    node (``LOCAL_WORLD_SIZE`` unset or the world size) the names are laid
    over the flat rank list, so code written against the hybrid mesh runs
    unchanged from one node to many.

    :param ici_axes: Axis sizes within a node, e.g. ``{"devices": 4}``.
        Defaults to one ``"devices"`` axis over the ranks of a node.
    :param dcn_axes: Axis sizes across nodes, e.g. ``{"hosts": 2}``.
        Defaults to one ``"hosts"`` axis over the nodes.
    :param devices: Global ranks to build the mesh from (defaults to all).
    """
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    num_nodes = max(len(ranks) // per_node, 1)
    if dcn_axes is None:
        dcn_axes = {"hosts": num_nodes}
    if ici_axes is None:
        ici_axes = {"devices": per_node}
    if num_nodes > 1:
        if math.prod(dcn_axes.values()) != num_nodes or math.prod(ici_axes.values()) != per_node:
            raise ValueError(
                f"DCN axes {dcn_axes} must multiply to the {num_nodes} nodes and ICI axes "
                f"{ici_axes} to the {per_node} ranks of a node."
            )
    return make_mesh({**dcn_axes, **ici_axes}, ranks)


def _dims_from_spec(spec: Sequence) -> dict:
    """``{axis or tuple of axes: tensor dimension}`` of a ``PartitionSpec``-
    like sequence (one entry per dimension: ``None``, an axis name or a
    tuple of names)."""
    return {
        tuple(entry) if isinstance(entry, (list, tuple)) else entry: dim
        for dim, entry in enumerate(spec)
        if entry is not None
    }


def make_process_local_array(
    local_data: Any,
    mesh: DeviceMesh,
    spec: Sequence,
    global_shape: tuple[int, ...] | None = None,
) -> DTensor:
    """The global ``DTensor`` whose shard on this rank is ``local_data``.

    The counterpart of ``jax.make_array_from_process_local_data``: every
    rank passes only the rows it owns. ``spec`` has one entry per
    dimension, ``None`` (replicated) or the mesh axis (or tuple of axes)
    that shards it. ``global_shape`` defaults to the local shape scaled by
    the sharded axes' sizes. Nothing is communicated.
    """
    local = torch.as_tensor(local_data)
    dims = _dims_from_spec(spec)
    if global_shape is None:
        shape = list(local.shape)
        for axes, dim in dims.items():
            shape[dim] *= collectives.axis_index(mesh, axes)[1]
        global_shape = tuple(shape)
    stride = torch.empty(global_shape, device="meta").stride()
    return DTensor.from_local(
        local, mesh, _placements(mesh, dims), run_check=False,
        shape=torch.Size(global_shape), stride=stride,
    )


def process_local_beam(
    beam: Any,
    mesh: DeviceMesh,
    instance_axis: str | Sequence[str] | None = None,
    particle_axis: str | Sequence[str] | None = None,
) -> Any:
    """The global beam, with ``DTensor`` fields, whose local blocks are the
    fields of this rank's ``beam``: the counterpart of
    :func:`shard_beam` for data made per rank (its own lattice settings or
    macroparticles). Fields not covered by the axes are taken as
    replicated: every rank must pass the same values for them (they are not
    broadcast, and a difference is not detected)."""
    placements = beam_shardings(beam, mesh, instance_axis, particle_axis)
    layout = _beam_dims(beam, instance_axis, particle_axis)
    leaves = {}
    for path, _, tensor in tree.flatten(beam):
        shape = list(tensor.shape)
        for axes, dim in layout.get(path, {}).items():
            shape[dim] *= collectives.axis_index(mesh, axes)[1]
        leaves[path] = DTensor.from_local(
            tensor, mesh, placements[path], run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride(),
        )
    return tree.rebuild(beam, leaves)
