"""Meshes and the local blocks of sharded beams and lattices (counterpart of
``cheetah_tpu/parallel/sharding.py``).

The JAX package places a beam or a lattice on a mesh (``NamedSharding``)
and lets XLA insert the collectives. The port runs explicit SPMD: every rank
holds its local block as plain tensors, and :func:`shard_beam` and
:func:`shard_segment` cut that block out of the global object. Layouts are
described in ``torch.distributed.tensor``'s placements (``Shard(d)``,
``Replicate()``), one per mesh axis, the counterpart of a ``PartitionSpec``.

- Instance-axis sharding is pure data parallelism: each rank tracks its
  own lattice settings and nothing crosses ranks.
- Particle-axis sharding needs the space-charge kick's grid and moment
  all-reduces (``SpaceChargeKick(particle_axis=...)``); every other element
  acts on each particle alone.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from cheetah_tpu_torch.parallel import collectives
from cheetah_tpu_torch.particles import ParameterBeam, ParticleBeam
from cheetah_tpu_torch.utils import tree

#: Trailing dimensions of the element parameters that are not instance
#: dimensions (every other parameter is a scalar per instance).
UNVECTORIZED_NDIM = {"misalignment": 1, "pixel_size": 1, "predefined_transfer_map": 2}


def _mesh_device_type() -> str:
    """The device type of a mesh on the default process group: ``"cuda"``
    where NCCL carries CUDA tensors, else ``"cpu"`` (gloo, which also
    all-reduces and broadcasts CUDA tensors)."""
    backend = str(dist.get_backend())
    return "cuda" if "nccl" in backend else "cpu"


def make_mesh(axis_sizes: dict[str, int] | None = None, devices: Sequence[int] | None = None) -> DeviceMesh:
    """Build a device mesh over the ranks of the default process group.

    :param axis_sizes: Mapping of axis name to size, e.g.
        ``{"instances": 4, "particles": 2}``. Defaults to one
        ``"instances"`` axis over all ranks.
    :param devices: Global ranks to lay the mesh over, row-major (defaults
        to all ranks; the first ``prod(sizes)`` are used).
    :raises RuntimeError: if no process group is initialised
        (:func:`cheetah_tpu_torch.parallel.initialize`).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "A mesh needs a process group: call cheetah_tpu_torch.parallel.initialize() "
            "(or torch.distributed.init_process_group) first."
        )
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if axis_sizes is None:
        axis_sizes = {"instances": len(ranks)}
    shape = tuple(axis_sizes.values())
    count = math.prod(shape)
    if count > len(ranks):
        raise ValueError(f"A mesh of shape {shape} needs {count} ranks; {len(ranks)} given.")
    return DeviceMesh(
        _mesh_device_type(),
        torch.tensor(ranks[:count]).reshape(shape),
        mesh_dim_names=tuple(axis_sizes.keys()),
    )


def _placements(mesh: DeviceMesh, dims: dict[str, int]) -> tuple:
    """One placement per mesh axis: ``Shard(d)`` where ``dims`` maps the
    axis (or a tuple of axes holding it) to tensor dimension ``d``."""
    by_axis = {
        name: dim for axes, dim in dims.items() for name in collectives.axis_names(axes)
    }
    return tuple(
        Shard(by_axis[name]) if name in by_axis else Replicate() for name in mesh.mesh_dim_names
    )


def _beam_dims(
    beam: ParticleBeam | ParameterBeam, instance_axis, particle_axis
) -> dict[str, dict]:
    """For each tensor field of ``beam``, the dimension each requested axis
    shards (the JAX package's ``leaf_spec``): the leading dimension of a
    vectorised field over the instance axis, the particle dimension over
    the particle axis."""
    if isinstance(beam, ParticleBeam):
        trailing = {"particles": 2, "particle_charges": 1, "survival_probabilities": 1,
                    "energy": 0, "s": 0}
    else:
        if particle_axis is not None:
            raise ValueError("ParameterBeam has no particle axis.")
        trailing = {"mu": 1, "cov": 2, "energy": 0, "total_charge": 0, "s": 0}
    layout = {}
    for field, count in trailing.items():
        ndim = getattr(beam, field).ndim
        dims = {}
        if instance_axis is not None and ndim > count:
            dims[instance_axis] = 0
        if particle_axis is not None and count >= 1:
            dims[particle_axis] = ndim - count
        layout[field] = dims
    return layout


def beam_shardings(
    beam: ParticleBeam | ParameterBeam,
    mesh: DeviceMesh,
    instance_axis: str | Sequence[str] | None = None,
    particle_axis: str | Sequence[str] | None = None,
) -> dict[str, tuple]:
    """The placements of every tensor of ``beam`` on ``mesh``, by module path
    (``"particles"``, ``"species.mass_eV"``, ...).

    :param instance_axis: Mesh axis (or tuple of axes) over which to shard
        the leading vector dimension of every field (requires the beam to
        be vectorised).
    :param particle_axis: Mesh axis (or tuple of axes) over which to shard
        the particle dimension (``ParticleBeam`` only).
    """
    layout = _beam_dims(beam, instance_axis, particle_axis)
    return {
        path: _placements(mesh, layout.get(path, {}))
        for path, _, _ in tree.flatten(beam)
    }


def _local_block(tensor: torch.Tensor, mesh: DeviceMesh, dims: dict) -> torch.Tensor:
    """This rank's block of ``tensor`` along each sharded dimension."""
    for axis, dim in dims.items():
        index, size = collectives.axis_index(mesh, axis)
        if tensor.shape[dim] % size:
            raise ValueError(
                f"Dimension {dim} of length {tensor.shape[dim]} does not divide over "
                f"axis {axis!r} of size {size}."
            )
        tensor = tensor.chunk(size, dim=dim)[index]
    return tensor


def shard_beam(
    beam: ParticleBeam | ParameterBeam,
    mesh: DeviceMesh,
    instance_axis: str | Sequence[str] | None = None,
    particle_axis: str | Sequence[str] | None = None,
) -> ParticleBeam | ParameterBeam:
    """This rank's block of a global ``beam``: its instances along
    ``instance_axis`` and its particles along ``particle_axis`` (views of
    the global tensors; each sharded length must divide over its axis)."""
    layout = _beam_dims(beam, instance_axis, particle_axis)
    return tree.rebuild(
        beam,
        {
            path: _local_block(tensor, mesh, layout[path])
            for path, _, tensor in tree.flatten(beam)
            if layout.get(path)
        },
    )


def _num_instances(segment: torch.nn.Module) -> int | None:
    """The instance count of a vectorised lattice: the leading length of
    its parameters that have more dimensions than one instance needs."""
    lengths = {
        tensor.shape[0]
        for path, _, tensor in tree.flatten(segment)
        if tensor.ndim > UNVECTORIZED_NDIM.get(path.rpartition(".")[2], 0)
        and tensor.shape[0] != 1
    }
    if len(lengths) > 1:
        raise ValueError(f"The lattice's parameters disagree on the instance count: {lengths}.")
    return lengths.pop() if lengths else None


def shard_segment(segment: torch.nn.Module, mesh: DeviceMesh, instance_axis: str | Sequence[str]):
    """This rank's block of a vectorised lattice: a copy in which every
    parameter whose leading dimension is the global instance count holds
    its rows along ``instance_axis``; the others (scalars, unvectorised
    parameters, length-1 broadcasts) are copied whole.

    Unlike the JAX package, which shards only the parameters whose leading
    length equals the axis's size and replicates the rest (a placement
    choice under GSPMD), the local blocks decide the numbers here: every
    instance-long parameter is cut, and the instance count must divide over
    the axis.
    """
    count = _num_instances(segment)
    if count is None:
        return tree.rebuild(segment, {})
    return tree.rebuild(
        segment,
        {
            path: _local_block(tensor, mesh, {instance_axis: 0})
            for path, _, tensor in tree.flatten(segment)
            if tensor.ndim > UNVECTORIZED_NDIM.get(path.rpartition(".")[2], 0)
            and tensor.shape[0] == count
        },
    )


def replicate(value: Any, mesh: DeviceMesh) -> Any:
    """``value`` (a tensor, lattice, beam or dict of them) as the mesh's
    first rank holds it, on every rank of the mesh: one broadcast per
    tensor."""
    axes = tuple(mesh.mesh_dim_names)
    return tree.rebuild(
        value,
        {path: collectives.broadcast(tensor, axes, mesh) for path, _, tensor in tree.flatten(value)},
    )
