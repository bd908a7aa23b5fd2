"""x-tiled multi-order CIC deposit and gather for grids past the untiled
bound: CUDA kernels and their plain PyTorch versions (counterpart of
``cheetah_tpu/ops/pallas_cic_tiled.py``).

Same contract as :func:`cheetah_tpu_torch.ops.cic_kernels.deposit_multi_3d`
and :func:`~cheetah_tpu_torch.ops.cic_kernels.gather_multi_3d`: shapes, up to
8 orders, float32 and float64, the bin-space conventions, and zero weight for
corners off the grid and for non-finite positions. The kernels are in
``cheetah_tpu_torch/csrc/cic_tiled.cu``; the note there says which TPU
kernel each one replaces and how it is laid out on the card.

Both the kernels and the plain versions follow one plan, made here in torch
(:func:`tile_plan`), as the JAX package makes it outside its ``pallas_call``:
each particle's x-tile ``clip(floor(x) // R, 0, T - 1)``, a ``torch.sort``
by tile, and the per-tile offsets into the sorted order. A particle of tile
``t`` touches grid rows ``t*R .. t*R + R``, an ``(R + 1)``-row window whose
last row (the halo) is the first row of tile ``t + 1``. The plain versions
hold the windows of all tiles side by side, deposit into or gather from
each particle's window with the untiled plain versions' corner sums, and
fold the halos (deposit) or write each output to the particle's original
index (gather).

CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise. Each wrapper counts its kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cheetah_tpu_torch.ops import cic_common
from cheetah_tpu_torch.ops.nvcc import CudaLibrary

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary(
    "cic_tiled.cu",
    {
        "cic_deposit_tiled": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
                              _I32, _I32, _I64, _P, _I32, _P],
        "cic_gather_tiled": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
                             _I32, _I64, _P, _I32, _P],
    },
)

# Window bounds of the JAX package's tiled kernels (pallas_cic_tiled.py
# ``_MAX_WINDOW_LEAD``, ``_MAX_WINDOW_CELLS``, ``_MAX_NT``), copied so that
# the port sends the same grids to the tiled kernels.
_MAX_WINDOW_LEAD = 4096
_MAX_WINDOW_CELLS = 262144
_MAX_NT = 512

#: One y-row of a tile's window (``R + 1`` x-rows by ``nt`` cells, float64)
#: fits the 48 KB of shared memory every block has, so that the deposit
#: kernel can always cut its window into y-slabs (``(1024, 1, 512)``, where
#: the JAX package's R is 255, would not fit otherwise).
_WINDOW_ROW_BYTES = 48 * 1024

#: Sorted particles a deposit block takes: a block zeroes and flushes its
#: whole window once per pass, so a run is long next to the window. A gather
#: block has no window, so its runs are short and spread over more blocks.
DEPOSIT_PER_RUN = 8192
GATHER_PER_RUN = 2048


def tiled_bounds_ok(histogram_shape) -> bool:
    """True when the minimal (R = 1) two-row window fits the JAX package's
    window bounds (``pallas_cic_tiled.py:76``), whatever ``nx`` is."""
    if len(histogram_shape) != 3:
        return False
    nx, ny, nt = histogram_shape
    return (
        2 * ny <= _MAX_WINDOW_LEAD
        and 2 * ny * nt <= _MAX_WINDOW_CELLS
        and nt <= _MAX_NT
        and nx >= 2
    )


def rows_per_tile(histogram_shape) -> int:
    """Grid rows per x-tile, as the JAX package picks them
    (``pallas_cic_tiled.py:90``): a window lead ``(R + 1) * ny`` near 256,
    within the window bounds; and, unlike there, small enough that one
    y-row of the window fits :data:`_WINDOW_ROW_BYTES`. The kernels size
    their shared-memory window from the card's budget on their own."""
    nx, ny, nt = histogram_shape
    rows = max(1, 256 // ny - 1)
    while rows > 1 and (
        (rows + 1) * ny > _MAX_WINDOW_LEAD or (rows + 1) * ny * nt > _MAX_WINDOW_CELLS
    ):
        rows -= 1
    return max(1, min(rows, nx - 1, _WINDOW_ROW_BYTES // (8 * nt) - 1))


class TilePlan(NamedTuple):
    """The sort-by-x-tile plan shared by the kernels and the plain versions."""

    rows_per_tile: int
    num_tiles: int
    #: ``(B, N)`` int32: the tile of each particle of the sorted order.
    sorted_tile: torch.Tensor
    #: ``(B, N)`` int64: the original index of each particle of the sorted order.
    perm: torch.Tensor
    #: ``(B, T + 1)`` int64: where each tile's particles start in the sorted order.
    offsets: torch.Tensor


def tile_plan(normalized: torch.Tensor, histogram_shape) -> TilePlan:
    """Tile key, sort and per-tile offsets for bin-space positions
    ``normalized (B, N, 3)``. The key is computed in floating point, so a
    non-finite or huge position never meets an int cast: NaN goes to tile 0
    and +-inf to the edge tiles, where every corner of it weighs 0."""
    nx = histogram_shape[0]
    rows = rows_per_tile(histogram_shape)
    num_tiles = -(-nx // rows)
    # floor(floor(x) / R) is exact floor division of the integer floor(x);
    # a particle with floor(x) = -1 still reaches row 0 from tile 0.
    tile = torch.floor(torch.floor(normalized[..., 0]) / rows).clamp(0, num_tiles - 1)
    tile = torch.nan_to_num(tile, nan=0.0).to(torch.int32)
    sorted_tile, perm = torch.sort(tile, dim=1, stable=True)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=tile.device)
    offsets = torch.searchsorted(
        sorted_tile, bounds.expand(tile.shape[0], -1).contiguous()
    )
    return TilePlan(rows, num_tiles, sorted_tile, perm, offsets)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the kernels' yardstick.
# ---------------------------------------------------------------------------


def _in_windows(normalized: torch.Tensor, plan: TilePlan):
    """The sorted positions with x in the frame of each particle's window,
    ``x - t*R`` (exact in floating point), and the flat offset of that
    window among the ``(T, R + 1, ny, nt)`` windows. A corner outside its
    window (row -1 of tile 0, rows past the last window) is off the grid
    too, so it weighs 0."""
    ordered = normalized.gather(1, plan.perm[..., None].expand(-1, -1, 3))
    tile = plan.sorted_tile.to(normalized.dtype)
    local = torch.cat(
        [(ordered[..., 0] - tile * plan.rows_per_tile)[..., None], ordered[..., 1:]], dim=-1
    )
    return local, plan.sorted_tile.long()


def deposit_multi_tiled_3d_reference(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: cic_common.Orders,
) -> torch.Tensor:
    """Plain version of :func:`deposit_multi_tiled_3d`: deposit the sorted
    particles into their tiles' windows, then fold each halo row into the
    next tile's first row."""
    orders = cic_common.check_orders(orders)
    nx, ny, nt = histogram_shape
    plan = tile_plan(normalized, histogram_shape)
    span, tiles = plan.rows_per_tile, plan.num_tiles
    window = (span + 1, ny, nt)
    local, tile = _in_windows(normalized, plan)
    rows_sorted = rows.gather(3, plan.perm[:, None, None, :].expand_as(rows))
    windows = cic_common.deposit_cells(
        local, rows_sorted, window, orders, tiles * (span + 1) * ny * nt,
        cell_offset=tile * ((span + 1) * ny * nt),
    ).view(rows.shape[0], rows.shape[2], tiles, *window)
    main = windows[:, :, :, :span].clone()
    main[:, :, 1:, 0] += windows[:, :, :-1, span]
    # The last tile's halo, and rows past nx, lie past the grid edge.
    return main.flatten(2, 3)[:, :, :nx]


def gather_multi_tiled_3d_reference(
    grids: torch.Tensor, normalized: torch.Tensor, orders: cic_common.Orders
) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`gather_multi_tiled_3d`: cut the grid into the
    tiles' windows (rows past nx read 0), gather the sorted particles from
    them, and write each output to the particle's original index."""
    orders = cic_common.check_orders(orders)
    batch, num_components, nx, ny, nt = grids.shape
    plan = tile_plan(normalized, (nx, ny, nt))
    span, tiles = plan.rows_per_tile, plan.num_tiles
    padded = torch.nn.functional.pad(grids, (0, 0, 0, 0, 0, tiles * span + 1 - nx))
    window_rows = (
        torch.arange(tiles, device=grids.device)[:, None] * span
        + torch.arange(span + 1, device=grids.device)[None, :]
    )
    windows = padded.index_select(2, window_rows.flatten()).reshape(batch, num_components, -1)
    local, tile = _in_windows(normalized, plan)
    sorted_outs = cic_common.gather_cells(
        windows, local, (span + 1, ny, nt), orders, cell_offset=tile * ((span + 1) * ny * nt)
    )
    index = plan.perm[:, None, :].expand_as(sorted_outs[0])
    return tuple(torch.empty_like(out).scatter_(2, index, out) for out in sorted_outs)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def deposit_multi_tiled_3d(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: cic_common.Orders,
) -> torch.Tensor:
    """x-tiled multi-order CIC deposit, with the contract of
    :func:`cheetah_tpu_torch.ops.cic_kernels.deposit_multi_3d`.

    CUDA tensors launch ``deposit_tiled_kernel`` (atomic adds, so the last
    bits change from run to run); CPU tensors run
    :func:`deposit_multi_tiled_3d_reference`.
    """
    orders, histogram_shape = cic_common.check_deposit_args(
        normalized, rows, histogram_shape, orders
    )
    if not tiled_bounds_ok(histogram_shape):
        raise ValueError(f"The grid is past the tiled kernels' bounds: {histogram_shape}")
    if normalized.device.type == "cpu":
        return deposit_multi_tiled_3d_reference(normalized, rows, histogram_shape, orders)

    batch, _, num_components, num_particles = rows.shape
    out = torch.zeros(
        (batch, num_components, *histogram_shape), dtype=rows.dtype, device=rows.device
    )
    if batch * num_particles * num_components == 0:
        return out
    normalized = normalized.contiguous()
    rows = rows.contiguous()
    plan = tile_plan(normalized, histogram_shape)
    LIBRARY.launch(
        "cic_deposit_tiled", rows.dtype, rows.device,
        normalized.data_ptr(), rows.data_ptr(), plan.perm.data_ptr(),
        plan.offsets.data_ptr(), out.data_ptr(), batch, num_particles, num_components,
        *histogram_shape, plan.rows_per_tile, plan.num_tiles, DEPOSIT_PER_RUN,
        *cic_common.orders_argument(orders),
    )
    deposit_multi_tiled_3d.launches += 1
    return out


deposit_multi_tiled_3d.launches = 0


def gather_multi_tiled_3d(
    grids: torch.Tensor, normalized: torch.Tensor, orders: cic_common.Orders
) -> tuple[torch.Tensor, ...]:
    """x-tiled multi-order trilinear gather, with the contract of
    :func:`cheetah_tpu_torch.ops.cic_kernels.gather_multi_3d`.

    CUDA tensors launch ``gather_tiled_kernel``; CPU tensors run
    :func:`gather_multi_tiled_3d_reference`.
    """
    orders = cic_common.check_gather_args(grids, normalized, orders)
    histogram_shape = tuple(grids.shape[2:])
    if not tiled_bounds_ok(histogram_shape):
        raise ValueError(f"The grid is past the tiled kernels' bounds: {histogram_shape}")
    if grids.device.type == "cpu":
        return gather_multi_tiled_3d_reference(grids, normalized, orders)

    batch, num_components = grids.shape[:2]
    num_particles = normalized.shape[1]
    out = torch.empty(
        (len(orders), batch, num_components, num_particles),
        dtype=grids.dtype, device=grids.device,
    )
    if batch * num_particles * num_components == 0:
        return tuple(out)
    grids = grids.contiguous()
    normalized = normalized.contiguous()
    plan = tile_plan(normalized, histogram_shape)
    LIBRARY.launch(
        "cic_gather_tiled", grids.dtype, grids.device,
        grids.data_ptr(), normalized.data_ptr(), plan.perm.data_ptr(),
        plan.offsets.data_ptr(), out.data_ptr(), batch, num_particles, num_components,
        *histogram_shape, plan.num_tiles, GATHER_PER_RUN,
        *cic_common.orders_argument(orders),
    )
    gather_multi_tiled_3d.launches += 1
    return tuple(out)


gather_multi_tiled_3d.launches = 0
