"""Every collective the port issues, on the axes of a device mesh.

The port runs explicit SPMD, one process per rank (the model of the JAX
package's ``shard_map``): each rank holds its local block as plain tensors,
and the communication is written out as calls of this module on the groups
of a named ``torch.distributed.device_mesh.DeviceMesh``. An axis is a mesh
axis name (``"particles"``), a tuple of names (``("hosts", "devices")``,
the ranks that differ only along those axes) or a ``ProcessGroup``. Names
are looked up on the mesh made current by :func:`active_mesh`.

:func:`all_reduce` is differentiable: its backward all-reduces (sums) the
cotangent, the transpose of JAX's ``psum``; its jvp all-reduces the tangent,
and under ``torch.func.vmap`` it sums the batched tensor whole. With the gradient convention of
the port (each rank calls backward on its own share of the loss; see
:class:`~cheetah_tpu_torch.accelerator.SpaceChargeKick`), that sum carries
the terms of the other ranks' losses. ``torch.distributed.all_reduce``
itself works in place and is invisible to autograd: it would drop them.

Every collective issued while a :func:`recording` is open, in forward and
in backward, is written down as one line of text (kind, dtype, shape and
the participant groups in global ranks), from which
:mod:`cheetah_tpu_torch.parallel.comm_audit` builds its report.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

from cheetah_tpu_torch.utils.maths import presigned

_MESH: contextvars.ContextVar = contextvars.ContextVar("cheetah_tpu_torch_mesh", default=None)
#: The open recordings. Shared by all threads, unlike a context variable:
#: autograd runs the backward of CUDA tensors on threads of its own.
_RECORDINGS: list[list[str]] = []

#: The JAX package's HLO type names, which the audit parses.
DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


@contextlib.contextmanager
def active_mesh(mesh) -> Iterator:
    """Make ``mesh`` the one whose axis names collectives resolve against,
    for the ``with`` block (the counterpart of tracing inside ``shard_map``
    over ``mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


@contextlib.contextmanager
def recording() -> Iterator[list[str]]:
    """Collect one line of text per collective issued in the block, by this
    rank, forward and backward alike."""
    lines: list[str] = []
    _RECORDINGS.append(lines)
    try:
        yield lines
    finally:
        _RECORDINGS[:] = [other for other in _RECORDINGS if other is not lines]


def axis_names(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_groups(mesh, names: tuple[str, ...]) -> list[list[int]]:
    """The participant groups of a collective over the mesh axes ``names``,
    in global ranks: the ranks that share their coordinates on every other
    axis, ordered row-major over ``names``."""
    dims = [mesh.mesh_dim_names.index(name) for name in names]
    others = [dim for dim in range(mesh.ndim) if dim not in dims]
    size = math.prod(mesh.size(dim) for dim in dims)
    return mesh.mesh.permute(*others, *dims).reshape(-1, size).tolist()


def axis_index(mesh, axis: str | Sequence[str]) -> tuple[int, int]:
    """This rank's index along ``axis`` (row-major over a tuple of names)
    and the axis's size."""
    index, size = 0, 1
    for name in axis_names(axis):
        index = index * mesh.size(mesh.mesh_dim_names.index(name)) + mesh.get_local_rank(name)
        size *= mesh.size(mesh.mesh_dim_names.index(name))
    return index, size


def resolve(axis, mesh=None) -> tuple[dist.ProcessGroup, list[list[int]]]:
    """The process group of ``axis`` for this rank and every participant
    group of a collective over it (a ``ProcessGroup``: its own ranks).

    :raises RuntimeError: if a name is given and no mesh is active.
    :raises ValueError: if a name is not an axis of the mesh.
    """
    if isinstance(axis, dist.ProcessGroup):
        return axis, [dist.get_process_group_ranks(axis)]
    mesh = mesh if mesh is not None else _MESH.get()
    if mesh is None:
        raise RuntimeError(
            f"Mesh axis {axis!r} named outside a mesh: run inside "
            "`with cheetah_tpu_torch.parallel.active_mesh(mesh):`, or pass a ProcessGroup."
        )
    names = axis_names(axis)
    unknown = [name for name in names if name not in mesh.mesh_dim_names]
    if unknown:
        raise ValueError(f"Axes {unknown} are not among the mesh's {mesh.mesh_dim_names}.")
    groups = axis_groups(mesh, names)
    if len(names) == 1:
        return mesh.get_group(names[0]), groups
    # Groups over several axes are made once per mesh, by every rank in the
    # same order (making a group is itself collective).
    cache = mesh.__dict__.setdefault("_cheetah_tpu_torch_groups", {})
    if names not in cache:
        cache[names] = dist.new_subgroups_by_enumeration(groups)[0]
    return cache[names], groups


def describe(kind: str, tensor: torch.Tensor, groups: list[list[int]]) -> str:
    """One recorded collective as text: kind, result type, participant groups."""
    shape = ",".join(str(size) for size in tensor.shape)
    listed = ",".join("{" + ",".join(str(rank) for rank in group) + "}" for group in groups)
    return f"{kind} {DTYPE_NAMES[tensor.dtype]}[{shape}] replica_groups={{{listed}}}"


def _issue(kind: str, tensor: torch.Tensor, group, groups, **kwargs) -> None:
    """Issue the collective in place on ``tensor`` and record it."""
    if kind == "all-reduce":
        dist.all_reduce(tensor, group=group)
    else:
        dist.broadcast(tensor, group=group, **kwargs)
    for lines in _RECORDINGS:
        lines.append(describe(kind, tensor, groups))


@presigned
class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of a group. Its derivative rules are all-reduces
    too, as JAX's for ``psum``: backward sums the cotangents, jvp the
    tangents, and under ``vmap`` the batched tensor is summed whole, its
    batch dimension kept."""

    @staticmethod
    def forward(tensor, group, groups):
        summed = tensor.clone(memory_format=torch.contiguous_format)
        _issue("all-reduce", summed, group, groups)
        return summed

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.groups = inputs

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group, ctx.groups), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _AllReduce.apply(tangent, ctx.group, ctx.groups)

    @staticmethod
    def vmap(info, in_dims, tensor, group, groups):
        return _AllReduce.apply(tensor, group, groups), in_dims[0]


def all_reduce(tensor: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of ``axis``, out of place and
    differentiable (backward: the sum of the cotangents)."""
    group, groups = resolve(axis, mesh)
    return _AllReduce.apply(tensor, group, groups)


def all_gather(tensor: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The ranks' ``tensor``\\ s along ``axis`` concatenated on dimension 0,
    in the axis's order: each rank writes its rows into zeros and the
    blocks are summed by :func:`all_reduce`. That works over gloo on CUDA
    tensors, where gloo has no ``all_gather``, and is differentiable."""
    group, groups = resolve(axis, mesh)
    members = next(ranks for ranks in groups if dist.get_rank() in ranks)
    position = members.index(dist.get_rank())
    padding = (0, 0) * tensor.ndim + (position, len(members) - 1 - position)
    padded = torch.nn.functional.pad(tensor[None], padding)
    return _AllReduce.apply(padded, group, groups).flatten(0, 1)


def broadcast(tensor: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """``tensor`` of the first rank of this rank's group along ``axis``, on
    every rank of it (out of place, not differentiable)."""
    group, groups = resolve(axis, mesh)
    source = dist.get_process_group_ranks(group)[0]
    copied = tensor.detach().clone(memory_format=torch.contiguous_format)
    _issue("collective-broadcast", copied, group, groups, src=source)
    return copied
