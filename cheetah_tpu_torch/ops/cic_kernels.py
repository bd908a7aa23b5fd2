"""Multi-order cloud-in-cell deposit and gather: the untiled CUDA kernels,
their plain PyTorch versions, the dispatch between the untiled and the
x-tiled pair, and the autograd closure (counterpart of
``cheetah_tpu/ops/pallas_cic.py``).

The untiled kernels are in ``cheetah_tpu_torch/csrc/cic.cu``; the note there
says which TPU kernel each one replaces and what bounds it on the card. The
deposit privatises the grid in shared memory where a component fits a
block (:func:`untiled_deposit_geometry`), else adds to int64 grids in
global memory; both add in fixed point, so that a deposit gives the same
bits on every run, as the JAX package's do. The
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, into ``cheetah_tpu_torch/build/``, and loaded
with ``ctypes``.

Layouts are those of the JAX kernels, so the two packages compare like with
like:

- ``deposit_multi_3d(normalized (B, N, 3), rows (B, O, C, N), (nx, ny, nt),
  orders) -> (B, C, nx, ny, nt)``, summed over the orders;
- ``gather_multi_3d(grids (B, C, nx, ny, nt), normalized (B, N, 3), orders)
  -> O x (B, C, N)``.

Orders and bin-space conventions are those of
:mod:`cheetah_tpu_torch.ops.cic_common`.

Dispatch, the rule of the JAX package (``pallas_cic.py:220-224``,
``:300-305``): a grid that fails :func:`fits_untiled` and passes
:func:`~cheetah_tpu_torch.ops.cic_tiled.tiled_bounds_ok` goes to the x-tiled
pair of :mod:`cheetah_tpu_torch.ops.cic_tiled`; every other grid goes to the
untiled pair here, which takes any grid size.

Each kernel entry point is a ``torch.library`` operator, the counterpart of
the JAX package's primitives (``pallas_cic.py:536-538``): here
``cheetah_tpu_torch::cic_deposit_multi`` (:data:`DEPOSIT_MULTI`) and
``cheetah_tpu_torch::cic_gather_multi`` (:data:`GATHER_MULTI`), whose
orders are a flat ``int[]``. The dispatcher picks the implementation by the
device of the tensors: the plain version for CPU tensors, the kernel for
CUDA tensors, and for the fake tensors of ``torch.export`` the fake
implementation, which gives the output's shape (the counterpart of
``def_abstract_eval``, ``:564``, ``:645``). No other implementation is
registered, so there is no fallback from the card to a plain version, and
everything that depends on the particle count (the zero-size branches, the
launch geometry, the device's limits) stays inside the implementations: a
program exported with a symbolic particle axis holds the operators, and
launches the kernels when it is called on CUDA tensors. The CUDA
implementations count their launches under the wrappers' names
(``deposit_multi_3d``, ``gather_multi_3d`` and the tiled pair's) in
:func:`cheetah_tpu_torch.utils.profiling.counters`.

Gradients: :class:`GatherMulti` and :class:`DepositMulti` are the autograd
closure of the pair (``pallas_cic.py:536-750``; the operators carry no
autograd rule of their own, since ``torch.library`` has no forward-mode
one), in the form ``torch.func`` transforms: a ``backward`` (the
transposes), a ``jvp`` (forward mode, so ``torch.func.jvp``, ``jacfwd``,
``hessian`` and ``torch.autograd.forward_ad``) and a ``vmap`` rule that
folds the mapped dimension into the kernels' batch axis. Each rule calls the two Functions
again, at the same or raised orders, so every transform and composition,
up to orders ``(1, 1, 1)``, runs on the kernels too. On a grid of the tiled
pair each Function makes the plan of its positions once, in forward
(:func:`~cheetah_tpu_torch.ops.cic_tiled.plan_tiles`), and hands it to the
Functions its rules call, so every launch of one node's backward, double
backward and jvp reuses it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from cheetah_tpu_torch.ops import cic_common, cic_tiled
from cheetah_tpu_torch.ops.cic_common import (
    VALUE,
    Orders,
    check_deposit_args,
    check_gather_args,
    check_orders,
    define_operator,
    deposit_cells,
    gather_cells,
    orders_argument,
    orders_flat,
    orders_from_flat,
)
from cheetah_tpu_torch.ops.nvcc import CudaLibrary
from cheetah_tpu_torch.utils.maths import presigned

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary(
    "cic.cu",
    {
        "cic_deposit_multi": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _I32, _I32,
                              _I32, _P, _I32, _P],
        "cic_gather_multi": [_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32, _P, _I32, _P],
    },
    untyped={"cic_device_limits": [_I32, _P]},
)

#: Particles a copy of the privatised deposit takes at least: fewer copies
#: of a grid for few particles (one copy writes the output directly).
MIN_COPY_PARTICLES = 4096


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the untiled pair: the CPU path and the kernels'
# yardstick.
# ---------------------------------------------------------------------------


def deposit_multi_3d_reference(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: Orders,
) -> torch.Tensor:
    """Plain version of :func:`deposit_multi_3d` with ``index_add_``."""
    orders = check_orders(orders)
    flat = deposit_cells(normalized, rows, histogram_shape, orders, math.prod(histogram_shape))
    return flat.view(*flat.shape[:2], *histogram_shape)


def gather_multi_3d_reference(
    grids: torch.Tensor, normalized: torch.Tensor, orders: Orders
) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`gather_multi_3d` with a flat ``gather``."""
    orders = check_orders(orders)
    flat = grids.reshape(*grids.shape[:2], -1)
    return gather_cells(flat, normalized, tuple(grids.shape[2:]), orders)


# ---------------------------------------------------------------------------
# Wrappers and dispatch
# ---------------------------------------------------------------------------


def fits_untiled(histogram_shape) -> bool:
    """The JAX package's whole-grid bound for its untiled kernels
    (``pallas_cic.py:471``): ``nx * ny <= 4096`` and ``nx * ny * nt <=
    262144``, up to the 64^3 corner. It is the TPU's VMEM bound and means
    nothing to the card's kernels, which take any grid; the port keeps it
    so that both packages send the same grids to the same pair."""
    return (
        len(histogram_shape) == 3
        and histogram_shape[0] * histogram_shape[1] <= 4096
        and math.prod(histogram_shape) <= 262144
    )


def uses_tiled(histogram_shape) -> bool:
    """Whether a grid goes to the x-tiled kernels (128^3, (160, 40, 16), ...)."""
    return not fits_untiled(histogram_shape) and cic_tiled.tiled_bounds_ok(histogram_shape)


class UntiledDepositGeometry(NamedTuple):
    """The privatised untiled deposit's launch (``deposit_private_kernel``):
    ``group`` components a block, ``copies`` copies of them per instance
    and group, each block taking ``shared`` bytes of shared memory (its
    window, :func:`~cheetah_tpu_torch.ops.cic_common.window_bytes`)."""

    group: int
    copies: int
    shared: int


@functools.lru_cache(maxsize=256)
def untiled_deposit_geometry(
    batch: int, components: int, num_particles: int, cells: int, accumulator: int,
    limits: cic_common.DeviceLimits,
) -> UntiledDepositGeometry | None:
    """The privatised deposit's launch for a call whose window cells take
    ``accumulator`` bytes (:func:`~cheetah_tpu_torch.ops.cic_common.accumulator_bytes`),
    or ``None`` where not one grid component fits a block's shared memory
    (64^3 in int32 is 1 MB, 32^3 in int64 256 KB) or the (group, instance)
    pairs pass the grid's y dimension: then ``deposit_multi_kernel`` adds
    to int64 grids in global memory.
    As many copies as fill the card with resident blocks
    (:func:`~cheetah_tpu_torch.ops.cic_common.window_blocks`: whole waves
    of them, so that no copy takes more than
    :data:`~cheetah_tpu_torch.ops.cic_common.MAX_WINDOW_PARTICLES`), and at
    most one per :data:`MIN_COPY_PARTICLES` particles."""
    group = cic_common.components_per_block(cells, accumulator, components, limits.budget)
    if group == 0:
        return None
    groups = -(-components // group)
    if groups * batch > 65535:
        return None
    shared = cic_common.window_bytes(group * cells, accumulator)
    blocks = cic_common.window_blocks(batch * groups * num_particles, limits, shared)
    copies = max(
        1,
        min(blocks // (groups * batch), num_particles // MIN_COPY_PARTICLES),
        -(-num_particles // cic_common.MAX_WINDOW_PARTICLES),
    )
    return UntiledDepositGeometry(group, copies, shared)


# ---------------------------------------------------------------------------
# The untiled pair as operators: the plain version for CPU tensors, the
# kernel for CUDA tensors, the output shapes for fake tensors.
# ---------------------------------------------------------------------------


def _deposit_plain(normalized, rows, histogram_shape, orders_flat) -> torch.Tensor:
    """``cic_deposit_multi`` on CPU tensors: :func:`deposit_multi_3d_reference`."""
    return deposit_multi_3d_reference(
        normalized, rows, tuple(histogram_shape), orders_from_flat(orders_flat)
    )


def _deposit_kernel(normalized, rows, histogram_shape, orders_flat) -> torch.Tensor:
    """``cic_deposit_multi`` on CUDA tensors: ``deposit_private_kernel``
    where :func:`untiled_deposit_geometry` finds a launch (its copies summed
    by ``deposit_reduce_kernel`` in a fixed order), else
    ``deposit_multi_kernel`` into int64 grids in a scratch allocated here;
    every add in fixed point, so the same inputs give the same bits on
    every run. Counts its launch as ``deposit_multi_3d``."""
    batch, _, num_components, num_particles = rows.shape
    orders = orders_from_flat(orders_flat)
    normalized = normalized.contiguous()
    rows = rows.contiguous()
    shape = (batch, num_components, *histogram_shape)
    if batch * num_particles * num_components == 0:
        return torch.zeros(shape, dtype=rows.dtype, device=rows.device)
    cells = math.prod(histogram_shape)
    geometry = untiled_deposit_geometry(
        batch, num_components, num_particles, cells,
        cic_common.accumulator_bytes(rows.dtype, orders),
        cic_common.device_limits(LIBRARY, rows.device),
    )
    out = torch.empty(shape, dtype=rows.dtype, device=rows.device)
    scratch = None
    if geometry is None:
        group, copies = 0, 1
        scratch = torch.empty(cic_common.fixed_scratch_bytes(batch * num_components, cells) // 8,
                              dtype=torch.int64, device=rows.device)
    else:
        group, copies, _ = geometry
        if copies > 1:
            scratch = torch.empty(batch * num_components * copies * cells, dtype=rows.dtype,
                                  device=rows.device)
    LIBRARY.launch(
        "cic_deposit_multi", rows.dtype, rows.device,
        normalized.data_ptr(), rows.data_ptr(), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel() * scratch.element_size(),
        batch, num_particles, num_components, *histogram_shape, group, copies,
        *orders_argument(orders),
    )
    cic_common.count_launch(deposit_multi_3d)
    return out


def _deposit_fake(normalized, rows, histogram_shape, orders_flat) -> torch.Tensor:
    return rows.new_empty((rows.shape[0], rows.shape[2], *histogram_shape))


#: ``cheetah_tpu_torch::cic_deposit_multi``: the untiled deposit, ``(B, C,
#: nx, ny, nt)`` from ``normalized (B, N, 3)`` and ``rows (B, O, C, N)``.
DEPOSIT_MULTI = define_operator(
    "cic_deposit_multi",
    "(Tensor normalized, Tensor rows, int[] histogram_shape, int[] orders_flat) -> Tensor",
    _deposit_plain, _deposit_kernel, _deposit_fake,
)


def _gather_plain(grids, normalized, orders_flat) -> torch.Tensor:
    """``cic_gather_multi`` on CPU tensors: :func:`gather_multi_3d_reference`,
    its outputs stacked."""
    return torch.stack(
        gather_multi_3d_reference(grids, normalized, orders_from_flat(orders_flat))
    )


def _gather_kernel(grids, normalized, orders_flat) -> torch.Tensor:
    """``cic_gather_multi`` on CUDA tensors: ``gather_staged_kernel`` where a
    component of the grid fits shared memory (the value and raised order
    sets), else ``gather_multi_kernel``. Counts its launch as
    ``gather_multi_3d``."""
    orders = orders_from_flat(orders_flat)
    batch, num_components, nx, ny, nt = grids.shape
    num_particles = normalized.shape[1]
    out = torch.empty(
        (len(orders), batch, num_components, num_particles),
        dtype=grids.dtype,
        device=grids.device,
    )
    if batch * num_particles * num_components == 0:
        return out
    grids = grids.contiguous()
    normalized = normalized.contiguous()
    LIBRARY.launch(
        "cic_gather_multi", grids.dtype, grids.device,
        grids.data_ptr(), normalized.data_ptr(), out.data_ptr(),
        batch, num_particles, num_components, nx, ny, nt, *orders_argument(orders),
    )
    cic_common.count_launch(gather_multi_3d)
    return out


def _gather_fake(grids, normalized, orders_flat) -> torch.Tensor:
    return grids.new_empty((len(orders_flat) // 3, *grids.shape[:2], normalized.shape[1]))


#: ``cheetah_tpu_torch::cic_gather_multi``: the untiled gather, ``(O, B, C,
#: N)`` from ``grids (B, C, nx, ny, nt)`` and ``normalized (B, N, 3)``.
GATHER_MULTI = define_operator(
    "cic_gather_multi",
    "(Tensor grids, Tensor normalized, int[] orders_flat) -> Tensor",
    _gather_plain, _gather_kernel, _gather_fake,
)


def _deposit_untiled(normalized, rows, histogram_shape, orders) -> torch.Tensor:
    """The untiled deposit (``cic_deposit_multi``) on arguments
    :func:`check_deposit_args` passed."""
    return DEPOSIT_MULTI(normalized, rows, histogram_shape, orders_flat(orders))


def _gather_untiled(grids, normalized, orders) -> tuple[torch.Tensor, ...]:
    """The untiled gather (``cic_gather_multi``) on arguments
    :func:`check_gather_args` passed, one output per order."""
    return GATHER_MULTI(grids, normalized, orders_flat(orders)).unbind(0)


def _no_plan(plan) -> None:
    if plan is not None:
        raise ValueError("A tile plan serves only grids of the tiled pair.")


def deposit_multi_3d(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: Orders,
    plan: cic_tiled.TilePlan | None = None,
) -> torch.Tensor:
    """Multi-order CIC deposit: bin-space positions ``normalized (B, N, 3)``
    and per-order row blocks ``rows (B, O, C, N)`` -> the grid ``(B, C, nx,
    ny, nt)``, summed over the orders.

    Grids past :func:`fits_untiled` go to
    :func:`~cheetah_tpu_torch.ops.cic_tiled.deposit_multi_tiled_3d` (with
    ``plan`` when given), the others to the untiled ``deposit_multi_kernel``
    (its plain version on CPU tensors).
    """
    orders, histogram_shape = check_deposit_args(normalized, rows, histogram_shape, orders)
    if uses_tiled(histogram_shape):
        return cic_tiled.deposit_multi_tiled_3d(
            normalized, rows, histogram_shape, orders, plan=plan
        )
    _no_plan(plan)
    return _deposit_untiled(normalized, rows, histogram_shape, orders)


deposit_multi_3d.launches = 0


def gather_multi_3d(
    grids: torch.Tensor,
    normalized: torch.Tensor,
    orders: Orders,
    plan: cic_tiled.TilePlan | None = None,
) -> tuple[torch.Tensor, ...]:
    """Multi-order trilinear gather: ``grids (B, C, nx, ny, nt)`` and
    bin-space positions ``normalized (B, N, 3)`` -> one ``(B, C, N)`` tensor
    per order. The exact adjoint of :func:`deposit_multi_3d`.

    Grids past :func:`fits_untiled` go to
    :func:`~cheetah_tpu_torch.ops.cic_tiled.gather_multi_tiled_3d` (with
    ``plan`` when given), the others to the untiled ``gather_multi_kernel``
    (its plain version on CPU tensors).
    """
    orders = check_gather_args(grids, normalized, orders)
    if uses_tiled(tuple(grids.shape[2:])):
        return cic_tiled.gather_multi_tiled_3d(grids, normalized, orders, plan=plan)
    _no_plan(plan)
    return _gather_untiled(grids, normalized, orders)


gather_multi_3d.launches = 0


# ---------------------------------------------------------------------------
# The autograd closure (counterpart of the primitives cic_gather_multi_p and
# cic_deposit_multi_p, pallas_cic.py:536-750).
# ---------------------------------------------------------------------------


def _raised(order):
    """(axis, raised order) pairs, dropping axes already at order 1, whose
    raise is identically zero a.e. (``pallas_cic.py:545``)."""
    return [
        (axis, tuple(v + (a == axis) for a, v in enumerate(order)))
        for axis in range(3)
        if order[axis] == 0
    ]


def _unique(orders):
    return tuple(dict.fromkeys(orders))


def _position_grad(terms, like: torch.Tensor) -> torch.Tensor:
    """Stack per-axis sums ``(B, N)`` into ``(B, N, 3)``, zeros where an
    axis got no term."""
    return torch.stack(
        [terms[axis] if axis in terms else torch.zeros_like(like) for axis in range(3)],
        dim=-1,
    )


def _accumulate(terms: dict, key, value: torch.Tensor) -> None:
    terms[key] = value if key not in terms else terms[key] + value


def _node_plan(plan, normalized: torch.Tensor, histogram_shape):
    """The plan an autograd node hands to its launches: the one it was
    given, else, on a grid of the tiled pair, one made from the positions'
    values (no gradient flows through a plan), else None."""
    if plan is not None or not uses_tiled(tuple(histogram_shape)):
        return plan
    return cic_tiled.plan_tiles(normalized.detach(), histogram_shape)


def _save_with_plan(ctx, plan, *tensors: torch.Tensor) -> None:
    """Save ``tensors`` and the tensors of ``plan`` (if any) for backward
    and forward mode. A plan saved as a tensor, not as an attribute of
    ``ctx``, is what ``torch.utils.checkpoint`` can drop after forward and
    make again when it runs the forward anew."""
    ctx.plan_sizes = None if plan is None else (plan.rows_per_tile, plan.num_tiles)
    plan_tensors = () if plan is None else tuple(plan[2:])
    ctx.save_for_backward(*tensors, *plan_tensors)
    ctx.save_for_forward(*tensors, *plan_tensors)


def _saved_with_plan(ctx, count: int) -> tuple:
    """The ``count`` tensors that :func:`_save_with_plan` saved, and the plan."""
    saved = ctx.saved_tensors
    plan = None if ctx.plan_sizes is None else cic_tiled.TilePlan(*ctx.plan_sizes, *saved[count:])
    return (*saved[:count], plan)


class _PlanSlot:
    """The tile plan of one autograd node. A Function's ``forward`` takes no
    ``ctx`` in the ``torch.func`` form, so it leaves the plan it made here,
    where ``setup_context``, which gets the same inputs, picks it up. Under
    ``torch.func.vmap`` the folded call gets a slot of its own: its
    positions are not the caller's."""

    __slots__ = ("plan",)

    def __init__(self, plan: cic_tiled.TilePlan | None = None) -> None:
        self.plan = plan


def _fold(tensor: torch.Tensor, dim: int | None, batch_size: int) -> torch.Tensor:
    """Fold a vmapped dimension into the leading batch axis (an unmapped
    tensor is repeated for every instance), as ``_fold_batch`` does
    (``pallas_cic.py:713-718``)."""
    if dim is None:
        tensor = tensor.expand(batch_size, *tensor.shape)
    else:
        tensor = tensor.movedim(dim, 0)
    return tensor.reshape(tensor.shape[0] * tensor.shape[1], *tensor.shape[2:])


def _unfold(tensor: torch.Tensor, batch_size: int) -> torch.Tensor:
    return tensor.reshape(batch_size, -1, *tensor.shape[1:])


@presigned
class GatherMulti(torch.autograd.Function):
    """:func:`gather_multi_3d` with gradients with respect to ``grids`` and
    ``normalized``, in the form that ``torch.func`` transforms.

    Backward: the grids' gradient is the deposit of the output gradients at
    the same orders (the transpose, ``pallas_cic.py:617-635``); the
    positions' gradient along an axis is the gather at the orders raised on
    that axis times the output gradients, summed over components and
    orders (the jvp, ``:570-614``, transposed). ``jvp``: the gather at the
    deduplicated raised orders times the position tangent, plus the gather
    of the grid tangent (``:570-614``). ``vmap``: the vmapped dimension is
    folded into the kernels' leading batch axis (``:713-733``). Every rule
    calls the two Functions again, so each transform and their compositions
    run on the kernels. ``slot`` (tiled grids only) holds the tile plan of
    ``normalized``; made in forward when not given, it serves every launch
    of the node's rules.
    """

    @staticmethod
    def forward(grids, normalized, orders, slot):
        slot.plan = _node_plan(slot.plan, normalized, grids.shape[2:])
        return gather_multi_3d(grids, normalized, orders, plan=slot.plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        grids, normalized, orders, slot = inputs
        ctx.orders = check_orders(orders)
        ctx.set_materialize_grads(False)
        _save_with_plan(ctx, slot.plan, grids, normalized)

    @staticmethod
    def backward(ctx, *grad_outs):
        grids, normalized, plan = _saved_with_plan(ctx, 2)
        live = [(grad, order) for grad, order in zip(grad_outs, ctx.orders) if grad is not None]
        grad_grids = grad_normalized = None
        if not live:
            return None, None, None, None
        if ctx.needs_input_grad[0]:
            rows = torch.stack([grad for grad, _ in live], dim=1)
            grad_grids = DepositMulti.apply(
                normalized, rows, tuple(grids.shape[2:]), tuple(order for _, order in live),
                _PlanSlot(plan),
            )
        if ctx.needs_input_grad[1]:
            need = _unique(r for _, order in live for _, r in _raised(order))
            terms: dict[int, torch.Tensor] = {}
            if need:
                raised = dict(
                    zip(need, GatherMulti.apply(grids, normalized, need, _PlanSlot(plan)))
                )
                for grad, order in live:
                    for axis, r in _raised(order):
                        _accumulate(terms, axis, (raised[r] * grad).sum(dim=1))
            grad_normalized = _position_grad(terms, normalized[..., 0])
        return grad_grids, grad_normalized, None, None

    @staticmethod
    def jvp(ctx, grids_dot, normalized_dot, *_):
        grids, normalized, plan = _saved_with_plan(ctx, 2)
        orders = ctx.orders
        terms: dict[int, torch.Tensor] = {}
        if normalized_dot is not None:
            need = _unique(r for order in orders for _, r in _raised(order))
            if need:
                raised = dict(
                    zip(need, GatherMulti.apply(grids, normalized, need, _PlanSlot(plan)))
                )
                for index, order in enumerate(orders):
                    for axis, r in _raised(order):
                        _accumulate(
                            terms, index, raised[r] * normalized_dot[..., axis].unsqueeze(1)
                        )
        if grids_dot is not None:
            gathered = GatherMulti.apply(grids_dot, normalized, orders, _PlanSlot(plan))
            for index, value in enumerate(gathered):
                _accumulate(terms, index, value)
        shape = (*grids.shape[:2], normalized.shape[1])
        return tuple(
            terms[index] if index in terms else grids.new_zeros(shape)
            for index in range(len(orders))
        )

    @staticmethod
    def vmap(info, in_dims, grids, normalized, orders, slot):
        size = info.batch_size
        outs = GatherMulti.apply(
            _fold(grids, in_dims[0], size), _fold(normalized, in_dims[1], size), orders,
            _PlanSlot(),
        )
        return tuple(_unfold(out, size) for out in outs), (0,) * len(outs)


@presigned
class DepositMulti(torch.autograd.Function):
    """:func:`deposit_multi_3d` with gradients with respect to
    ``normalized`` and ``rows``, in the form that ``torch.func`` transforms.

    Backward: the rows' gradient is the gather of the grid's gradient at
    the same orders (the transpose, ``pallas_cic.py:694-707``); the
    positions' gradient along an axis is the gather at the orders raised on
    that axis, weighted by the rows (the jvp, ``:654-691``, transposed).
    Both come from one gather over the union of the orders. ``jvp``: one
    deposit of the rows tangent at the original orders together with the
    rows times the position tangent at the raised orders (``:654-691``),
    rows of a repeated order added. ``vmap`` and ``slot`` as for
    :class:`GatherMulti`.
    """

    @staticmethod
    def forward(normalized, rows, histogram_shape, orders, slot):
        slot.plan = _node_plan(slot.plan, normalized, histogram_shape)
        return deposit_multi_3d(normalized, rows, histogram_shape, orders, plan=slot.plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        normalized, rows, histogram_shape, orders, slot = inputs
        ctx.orders = check_orders(orders)
        ctx.histogram_shape = tuple(histogram_shape)
        ctx.set_materialize_grads(False)
        _save_with_plan(ctx, slot.plan, normalized, rows)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:
            return None, None, None, None, None
        normalized, rows, plan = _saved_with_plan(ctx, 2)
        orders = ctx.orders
        want = list(orders) if ctx.needs_input_grad[1] else []
        if ctx.needs_input_grad[0]:
            want += [r for order in orders for _, r in _raised(order)]
        want = _unique(want)
        if not want:
            return None, None, None, None, None
        gathered = dict(zip(want, GatherMulti.apply(grad, normalized, want, _PlanSlot(plan))))
        grad_normalized = grad_rows = None
        if ctx.needs_input_grad[0]:
            terms: dict[int, torch.Tensor] = {}
            for index, order in enumerate(orders):
                for axis, r in _raised(order):
                    _accumulate(terms, axis, (rows[:, index] * gathered[r]).sum(dim=1))
            grad_normalized = _position_grad(terms, normalized[..., 0])
        if ctx.needs_input_grad[1]:
            grad_rows = torch.stack([gathered[order] for order in orders], dim=1)
        return grad_normalized, grad_rows, None, None, None

    @staticmethod
    def jvp(ctx, normalized_dot, rows_dot, *_):
        normalized, rows, plan = _saved_with_plan(ctx, 2)
        blocks: dict[tuple[int, int, int], torch.Tensor] = {}
        if rows_dot is not None:
            for index, order in enumerate(ctx.orders):
                _accumulate(blocks, order, rows_dot[:, index])
        if normalized_dot is not None:
            for index, order in enumerate(ctx.orders):
                for axis, r in _raised(order):
                    _accumulate(blocks, r, rows[:, index] * normalized_dot[..., axis].unsqueeze(1))
        if not blocks:
            return rows.new_zeros((rows.shape[0], rows.shape[2], *ctx.histogram_shape))
        return DepositMulti.apply(
            normalized, torch.stack(list(blocks.values()), dim=1), ctx.histogram_shape,
            tuple(blocks), _PlanSlot(plan),
        )

    @staticmethod
    def vmap(info, in_dims, normalized, rows, histogram_shape, orders, slot):
        size = info.batch_size
        out = DepositMulti.apply(
            _fold(normalized, in_dims[0], size), _fold(rows, in_dims[1], size),
            histogram_shape, orders, _PlanSlot(),
        )
        return _unfold(out, size), 0


@torch.compiler.allow_in_graph
def differentiable_gather(
    grids: torch.Tensor, normalized: torch.Tensor, orders: Orders = VALUE
) -> tuple[torch.Tensor, ...]:
    """:func:`gather_multi_3d` that autograd differentiates on the kernels
    (counterpart of ``differentiable_pallas_gather``, ``pallas_cic.py:754``)."""
    return GatherMulti.apply(grids, normalized, orders, _PlanSlot())


@torch.compiler.allow_in_graph
def differentiable_deposit(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: Orders = VALUE,
) -> torch.Tensor:
    """:func:`deposit_multi_3d` that autograd differentiates on the kernels
    (counterpart of ``differentiable_pallas_deposit``, ``pallas_cic.py:775``)."""
    return DepositMulti.apply(normalized, rows, histogram_shape, orders, _PlanSlot())
