"""x-tiled multi-order CIC deposit and gather for grids past the untiled
bound: CUDA kernels and their plain PyTorch versions (counterpart of
``cheetah_tpu/ops/pallas_cic_tiled.py``).

Same contract as :func:`cheetah_tpu_torch.ops.cic_kernels.deposit_multi_3d`
and :func:`~cheetah_tpu_torch.ops.cic_kernels.gather_multi_3d`: shapes, up to
8 orders, float32 and float64, the bin-space conventions, and zero weight for
corners off the grid and for non-finite positions. The kernels are in
``cheetah_tpu_torch/csrc/cic_tiled.cu``; the note there says which TPU
kernel each one replaces and how it is laid out on the card.

Both the kernels and the plain versions follow one plan (:class:`TilePlan`),
as the JAX package makes one outside its ``pallas_call``
(``_sort_by_tile``): each particle's x-tile ``clip(floor(x) // R, 0, T -
1)`` (NaN to tile 0), a stable sort of the particles by tile with their
positions as payload, and the per-tile offsets into the sorted order. A
particle of tile ``t`` touches grid rows ``t*R .. t*R + R``, an ``(R +
1)``-row window whose last row (the halo) is the first row of tile ``t +
1``. The plain versions hold the windows of all tiles side by side, deposit
into or gather from each particle's window with the untiled plain versions'
corner sums, and fold the halos (deposit) or write each output to the
particle's original index (gather).

What bounds each kernel on the card, and what the design does about it
(device times by CUDA-graph replay on an H100 80GB HBM3 at 700 W, 1M
particles at 128^3; PERF.md):

- The plan (:func:`plan_tiles`). With ``torch.sort`` and ``searchsorted``
  (:func:`tile_plan`, now the plain version) it took some ten launches and
  0.107 ms. On the card it is a
  hand-written stable counting sort in two launches (three for a large
  count matrix): per-block tile counts, then a stable scatter of each
  block's chunk, sorted in shared memory first so that its writes are
  contiguous. It writes the positions in sorted order and each particle's
  place (``rank``) as payload. Its two passes over each chunk and the
  latency of each block's steps bound it (0.047 ms).
- The gather reads its run's sorted positions contiguously (before, each
  12-byte position read through ``perm`` cost its own 32-byte sector), and
  the 8 corners of each particle from the tile's window, staged in shared
  memory by a bulk copy where it fits (else read through L1 and L2), with
  a body specialised on the order set. It writes the outputs in sorted
  order, coalesced, and a second kernel moves them to the original indices
  through ``rank``: writing them there directly, a partial sector per
  value, cost more than the gather itself. 0.053 ms for the kernels.
- The deposit reads the plan's sorted positions, contiguously, in chunks
  of about equal work, one block each (:func:`tiled_deposit_geometry` sizes
  them): a tile's segment of a chunk is added into the tile's window in
  shared memory (int32 fixed point for the value order set, since Hopper
  has no shared-memory float add) and the window into int64 grids by bulk
  reductions, or, for a sparse tile, straight to those grids; a last pass
  writes the output from them. Every add is an integer add, so the
  deposit gives the same bits on every run. Shared-memory atomics and the
  windows' zeroing and flush bound it (PERF.md).
- One plan per autograd node: :class:`~cheetah_tpu_torch.ops.cic_kernels.GatherMulti`
  and :class:`~cheetah_tpu_torch.ops.cic_kernels.DepositMulti` make the plan
  of their positions once, in forward, and hand it (``plan=``) to every
  launch of their backward and of a double backward: 4 plans per gradient
  of the two-kick segment instead of 10.
- Tensor cores play no part: a gather does 8 multiply-adds per particle,
  component and order, where the TPU's two-hot products would multiply
  thousands of zeros for every 8 non-zeros.

The plan and the two kernels are ``torch.library`` operators, as the
untiled pair is (:mod:`cheetah_tpu_torch.ops.cic_kernels`):
``cheetah_tpu_torch::cic_tile_plan`` (:data:`TILE_PLAN`),
``cic_deposit_tiled`` (:data:`DEPOSIT_TILED`) and ``cic_gather_tiled``
(:data:`GATHER_TILED`), the last two taking the plan's tensors. CPU tensors
run the plain versions, CUDA tensors launch the kernels or raise, fake
tensors get the outputs' shapes; the plan's count scratch, sized from the
particle count, and the deposit's int64 grids stay inside the CUDA
implementations, and ``R`` and ``T`` are Python ints of the static grid. Each CUDA implementation counts its
launches under its wrapper's name (:func:`cic_common.count_launch`);
:func:`tile_plan` counts its calls in ``calls``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cheetah_tpu_torch.ops import cic_common
from cheetah_tpu_torch.ops.nvcc import CudaLibrary

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary(
    "cic_tiled.cu",
    {
        "cic_deposit_tiled": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32,
                              _I32, _I32, _I32, _I64, _I32, _I64, _P, _I32, _P],
        "cic_gather_tiled": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
                             _I32, _I32, _I64, _P, _I32, _P],
        "cic_tile_plan": [_P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P],
    },
    untyped={"cic_device_limits": [_I32, _P]},
)

# Window bounds of the JAX package's tiled kernels (pallas_cic_tiled.py
# ``_MAX_WINDOW_LEAD``, ``_MAX_WINDOW_CELLS``, ``_MAX_NT``), copied so that
# the port sends the same grids to the tiled kernels.
_MAX_WINDOW_LEAD = 4096
_MAX_WINDOW_CELLS = 262144
_MAX_NT = 512

#: One y-row of a tile's window (``R + 1`` x-rows by ``nt`` cells, float64)
#: fits 48 KB, so that a grid like ``(1024, 1, 512)``, where the JAX
#: package's R is 255, keeps a window that fits a deposit block's shared
#: memory (48 KB, not 2 MB).
_WINDOW_ROW_BYTES = 48 * 1024

#: Sorted particles a gather block takes: a gather block has no window, so
#: its runs are short and spread over many blocks. A deposit block's chunk
#: is sized by :func:`tiled_deposit_geometry`.
GATHER_PER_RUN = 2048
#: The fewest sorted particles a deposit block takes on average.
MIN_DEPOSIT_RUN = 1024
#: A tile's segment of a deposit chunk shorter than its window's cells over
#: this adds its corners to the global grid directly: zeroing and scanning
#: the window (two passes over its cells) would cost more than its
#: particles' 8 global atomics each.
WINDOW_CELLS_PER_RUN_PARTICLE = 16

#: Particles one warp of the plan's kernels takes (``kPlanSlice`` in
#: cic_tiled.cu): the plan's count matrix has at most ``ceil(N / 128)``
#: chunks per tile and instance, whatever layout the kernels pick.
_PLAN_SLICE = 128


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
    """The sort-by-x-tile plan shared by the kernels and the plain versions,
    made by :func:`plan_tiles` (or :func:`tile_plan`) from the positions it
    serves; a deposit or gather given ``plan=`` must get those positions."""

    rows_per_tile: int
    num_tiles: int
    #: ``(B, N)`` int32: the tile of each particle of the sorted order.
    sorted_tile: torch.Tensor
    #: ``(B, N)`` int64: the original index of each particle of the sorted order.
    perm: torch.Tensor
    #: ``(B, T + 1)`` int64: where each tile's particles start in the sorted order.
    offsets: torch.Tensor
    #: ``(B, N, 3)``: the positions in sorted order.
    sorted_positions: torch.Tensor
    #: ``(B, N)`` int64: each particle's place in the sorted order (the
    #: inverse of ``perm``).
    rank: torch.Tensor


def tile_plan(normalized: torch.Tensor, histogram_shape) -> TilePlan:
    """Plain version of :func:`plan_tiles`: tile key, stable ``torch.sort``
    and per-tile offsets for bin-space positions ``normalized (B, N, 3)``.
    The key is computed in floating point, so a non-finite or huge position
    never meets an int cast: NaN goes to tile 0 and +-inf to the edge tiles,
    where every corner of it weighs 0. Counts its calls in ``calls``."""
    tile_plan.calls += 1
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
    sorted_positions = normalized.gather(1, perm[..., None].expand(-1, -1, 3))
    places = torch.arange(perm.shape[1], device=perm.device).expand_as(perm)
    rank = torch.empty_like(perm).scatter_(1, perm, places)
    return TilePlan(rows, num_tiles, sorted_tile, perm, offsets, sorted_positions, rank)


tile_plan.calls = 0


@functools.lru_cache(maxsize=256)
def _tiling(histogram_shape: tuple[int, int, int]) -> tuple[int, int]:
    """``(R, T)``: grid rows per x-tile and the number of tiles, Python
    ints of the static grid."""
    rows = rows_per_tile(histogram_shape)
    return rows, -(-histogram_shape[0] // rows)


def _plan_plain(normalized, histogram_shape) -> tuple[torch.Tensor, ...]:
    """``cic_tile_plan`` on CPU tensors: :func:`tile_plan`'s tensors."""
    return tuple(tile_plan(normalized, tuple(histogram_shape))[2:])


def _plan_kernel(normalized, histogram_shape) -> tuple[torch.Tensor, ...]:
    """``cic_tile_plan`` on CUDA tensors: the counting-sort kernels of
    ``cic_tiled.cu`` (two or three launches, counted once as
    ``plan_tiles``), whose plan equals :func:`tile_plan`'s
    exactly, the sort being stable."""
    batch, num_particles, _ = normalized.shape
    rows, num_tiles = _tiling(tuple(histogram_shape))
    device = normalized.device
    sorted_tile = torch.empty((batch, num_particles), dtype=torch.int32, device=device)
    perm = torch.empty((batch, num_particles), dtype=torch.int64, device=device)
    rank = torch.empty_like(perm)
    sorted_positions = torch.empty_like(normalized, memory_format=torch.contiguous_format)
    empty = batch * num_particles == 0
    offsets = (torch.zeros if empty else torch.empty)(
        (batch, num_tiles + 1), dtype=torch.int64, device=device
    )
    if empty:
        return sorted_tile, perm, offsets, sorted_positions, rank
    counts = torch.empty(
        batch * num_tiles * -(-num_particles // _PLAN_SLICE), dtype=torch.int32, device=device
    )
    normalized = normalized.contiguous()
    LIBRARY.launch(
        "cic_tile_plan", normalized.dtype, device,
        normalized.data_ptr(), counts.data_ptr(), counts.numel(), perm.data_ptr(),
        rank.data_ptr(), sorted_tile.data_ptr(), sorted_positions.data_ptr(),
        offsets.data_ptr(), batch, num_particles, rows, num_tiles,
    )
    cic_common.count_launch(plan_tiles)
    return sorted_tile, perm, offsets, sorted_positions, rank


def _plan_fake(normalized, histogram_shape) -> tuple[torch.Tensor, ...]:
    batch, num_particles, _ = normalized.shape
    _, num_tiles = _tiling(tuple(histogram_shape))
    return (
        normalized.new_empty((batch, num_particles), dtype=torch.int32),
        normalized.new_empty((batch, num_particles), dtype=torch.int64),
        normalized.new_empty((batch, num_tiles + 1), dtype=torch.int64),
        normalized.new_empty((batch, num_particles, 3)),
        normalized.new_empty((batch, num_particles), dtype=torch.int64),
    )


#: ``cheetah_tpu_torch::cic_tile_plan``: the tensors of a :class:`TilePlan`
#: (``sorted_tile``, ``perm``, ``offsets``, ``sorted_positions``, ``rank``)
#: of ``normalized (B, N, 3)`` on a grid.
TILE_PLAN = cic_common.define_operator(
    "cic_tile_plan",
    "(Tensor normalized, int[] histogram_shape) -> "
    "(Tensor sorted_tile, Tensor perm, Tensor offsets, Tensor sorted_positions, Tensor rank)",
    _plan_plain, _plan_kernel, _plan_fake,
)


def plan_tiles(normalized: torch.Tensor, histogram_shape) -> TilePlan:
    """The plan of ``normalized (B, N, 3)`` on ``histogram_shape``, made by
    the operator ``cic_tile_plan``: on CUDA tensors the counting-sort
    kernels, on CPU tensors :func:`tile_plan`."""
    if normalized.dim() != 3 or normalized.shape[-1] != 3:
        raise ValueError(f"normalized must be (B, N, 3): {tuple(normalized.shape)}")
    histogram_shape = tuple(int(n) for n in histogram_shape)
    if not tiled_bounds_ok(histogram_shape):
        raise ValueError(f"The grid is past the tiled kernels' bounds: {histogram_shape}")
    return TilePlan(*_tiling(histogram_shape), *TILE_PLAN(normalized, histogram_shape))


plan_tiles.launches = 0


def _check_plan(plan: TilePlan, normalized: torch.Tensor, histogram_shape) -> TilePlan:
    """The plan given, or one made here; raises on a plan of other shapes."""
    if plan is None:
        return plan_tiles(normalized, histogram_shape)
    if (
        plan.rows_per_tile != rows_per_tile(histogram_shape)
        or plan.perm.shape != normalized.shape[:2]
        or plan.sorted_positions.shape != normalized.shape
        or plan.perm.device != normalized.device
    ):
        raise ValueError("The plan was not made for these positions and this grid.")
    return plan


class TiledDepositGeometry(NamedTuple):
    """The x-tiled deposit's launch (``deposit_tiled_kernel``): ``group``
    components a block; ``ceil(N / per_run)`` chunks of the sorted
    particles, one a block (the kernel weighs their bounds by cost); a
    window only for a tile's segment of ``min_window_run`` particles or
    more; ``shared`` bytes a block (its windows and, for int32 windows,
    their stage; 0: no window fits, every corner is added to the int64
    grids in global memory)."""

    group: int
    per_run: int
    min_window_run: int
    shared: int


@functools.lru_cache(maxsize=256)
def tiled_deposit_geometry(
    batch: int, components: int, num_particles: int, window_cells: int, accumulator: int,
    limits: cic_common.DeviceLimits,
) -> TiledDepositGeometry:
    """The x-tiled deposit's launch for a call whose window cells take
    ``accumulator`` bytes (:func:`~cheetah_tpu_torch.ops.cic_common.accumulator_bytes`).
    A block holds the windows of ``window_cells`` cells of as many
    components as fit its shared memory, with the stage that an int32
    window is flushed through
    (:data:`~cheetah_tpu_torch.ops.cic_common.STAGE_BYTES`); where not one
    fits, the kernel runs without windows, all components a block. There
    are as many chunks as fill the card with resident blocks
    (:func:`~cheetah_tpu_torch.ops.cic_common.window_blocks`; at least
    :data:`MIN_DEPOSIT_RUN` particles a chunk on average)."""
    stage = cic_common.STAGE_BYTES if accumulator == 4 else 0
    group = cic_common.components_per_block(
        window_cells, accumulator, components, limits.budget, stage
    )
    shared = cic_common.window_bytes(group * window_cells, accumulator, stage) if group else 0
    group = group or components
    groups = -(-components // group)
    blocks = cic_common.window_blocks(batch * groups * num_particles, limits, shared)
    per_run = min(
        max(MIN_DEPOSIT_RUN, -(-batch * groups * num_particles // blocks)),
        cic_common.MAX_WINDOW_PARTICLES,
    )
    min_window_run = -(-window_cells // WINDOW_CELLS_PER_RUN_PARTICLE)
    return TiledDepositGeometry(group, per_run, min_window_run, shared)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the kernels' yardstick.
# ---------------------------------------------------------------------------


def _in_windows(plan: TilePlan):
    """The sorted positions with x in the frame of each particle's window,
    ``x - t*R`` (exact in floating point), and the flat offset of that
    window among the ``(T, R + 1, ny, nt)`` windows. A corner outside its
    window (row -1 of tile 0, rows past the last window) is off the grid
    too, so it weighs 0."""
    ordered = plan.sorted_positions
    tile = plan.sorted_tile.to(ordered.dtype)
    local = torch.cat(
        [(ordered[..., 0] - tile * plan.rows_per_tile)[..., None], ordered[..., 1:]], dim=-1
    )
    return local, plan.sorted_tile.long()


def deposit_multi_tiled_3d_reference(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: cic_common.Orders,
    plan: TilePlan | None = None,
) -> torch.Tensor:
    """Plain version of :func:`deposit_multi_tiled_3d`: deposit the sorted
    particles into their tiles' windows, then fold each halo row into the
    next tile's first row. Makes its plan with :func:`tile_plan` unless
    ``plan`` is given."""
    orders = cic_common.check_orders(orders)
    nx, ny, nt = histogram_shape
    if plan is None:
        plan = tile_plan(normalized, histogram_shape)
    span, tiles = plan.rows_per_tile, plan.num_tiles
    window = (span + 1, ny, nt)
    local, tile = _in_windows(plan)
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
    grids: torch.Tensor,
    normalized: torch.Tensor,
    orders: cic_common.Orders,
    plan: TilePlan | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`gather_multi_tiled_3d`: cut the grid into the
    tiles' windows (rows past nx read 0), gather the sorted particles from
    them, and write each output to the particle's original index. Makes its
    plan with :func:`tile_plan` unless ``plan`` is given."""
    orders = cic_common.check_orders(orders)
    batch, num_components, nx, ny, nt = grids.shape
    if plan is None:
        plan = tile_plan(normalized, (nx, ny, nt))
    span, tiles = plan.rows_per_tile, plan.num_tiles
    padded = torch.nn.functional.pad(grids, (0, 0, 0, 0, 0, tiles * span + 1 - nx))
    window_rows = (
        torch.arange(tiles, device=grids.device)[:, None] * span
        + torch.arange(span + 1, device=grids.device)[None, :]
    )
    windows = padded.index_select(2, window_rows.flatten()).reshape(batch, num_components, -1)
    local, tile = _in_windows(plan)
    sorted_outs = cic_common.gather_cells(
        windows, local, (span + 1, ny, nt), orders, cell_offset=tile * ((span + 1) * ny * nt)
    )
    index = plan.perm[:, None, :].expand_as(sorted_outs[0])
    return tuple(torch.empty_like(out).scatter_(2, index, out) for out in sorted_outs)


# ---------------------------------------------------------------------------
# The tiled pair as operators, and their wrappers
# ---------------------------------------------------------------------------


def _given_plan(histogram_shape, sorted_tile, perm, offsets, sorted_positions, rank) -> TilePlan:
    return TilePlan(*_tiling(tuple(histogram_shape)), sorted_tile, perm, offsets,
                    sorted_positions, rank)


def _deposit_plain(normalized, rows, histogram_shape, orders_flat, *plan) -> torch.Tensor:
    """``cic_deposit_tiled`` on CPU tensors:
    :func:`deposit_multi_tiled_3d_reference` on the plan given."""
    return deposit_multi_tiled_3d_reference(
        normalized, rows, tuple(histogram_shape), cic_common.orders_from_flat(orders_flat),
        plan=_given_plan(histogram_shape, *plan),
    ).contiguous()


def _deposit_kernel(normalized, rows, histogram_shape, orders_flat, *plan) -> torch.Tensor:
    """``cic_deposit_tiled`` on CUDA tensors: ``deposit_tiled_kernel`` on the
    plan's sorted positions, sized by :func:`tiled_deposit_geometry`, into
    int64 grids in a scratch allocated here, every add in fixed point, so
    the same inputs give the same bits on every run. Counts its launch as
    ``deposit_multi_tiled_3d``."""
    plan = _given_plan(histogram_shape, *plan)
    orders = cic_common.orders_from_flat(orders_flat)
    batch, _, num_components, num_particles = rows.shape
    shape = (batch, num_components, *histogram_shape)
    if batch * num_particles * num_components == 0:
        return torch.zeros(shape, dtype=rows.dtype, device=rows.device)
    out = torch.empty(shape, dtype=rows.dtype, device=rows.device)
    rows = rows.contiguous()
    nx, ny, nt = histogram_shape
    geometry = tiled_deposit_geometry(
        batch, num_components, num_particles, (plan.rows_per_tile + 1) * ny * nt,
        cic_common.accumulator_bytes(rows.dtype, orders),
        cic_common.device_limits(LIBRARY, rows.device),
    )
    scratch = torch.empty(
        cic_common.fixed_scratch_bytes(batch * num_components, nx * ny * nt) // 8,
        dtype=torch.int64, device=rows.device,
    )
    LIBRARY.launch(
        "cic_deposit_tiled", rows.dtype, rows.device,
        plan.sorted_positions.data_ptr(), rows.data_ptr(), plan.perm.data_ptr(),
        plan.offsets.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel() * scratch.element_size(), batch, num_particles, num_components,
        *histogram_shape, plan.rows_per_tile, plan.num_tiles, geometry.per_run,
        geometry.group, geometry.min_window_run, *cic_common.orders_argument(orders),
    )
    cic_common.count_launch(deposit_multi_tiled_3d)
    return out


def _deposit_fake(normalized, rows, histogram_shape, orders_flat, *plan) -> torch.Tensor:
    return rows.new_empty((rows.shape[0], rows.shape[2], *histogram_shape))


_PLAN_ARGUMENTS = (
    "Tensor sorted_tile, Tensor perm, Tensor offsets, Tensor sorted_positions, Tensor rank"
)

#: ``cheetah_tpu_torch::cic_deposit_tiled``: the x-tiled deposit, with the
#: contract of ``cic_deposit_multi``, on the tensors of the positions'
#: :class:`TilePlan`.
DEPOSIT_TILED = cic_common.define_operator(
    "cic_deposit_tiled",
    "(Tensor normalized, Tensor rows, int[] histogram_shape, int[] orders_flat, "
    f"{_PLAN_ARGUMENTS}) -> Tensor",
    _deposit_plain, _deposit_kernel, _deposit_fake,
)


def _gather_plain(grids, normalized, orders_flat, *plan) -> torch.Tensor:
    """``cic_gather_tiled`` on CPU tensors:
    :func:`gather_multi_tiled_3d_reference` on the plan given, its outputs
    stacked."""
    return torch.stack(gather_multi_tiled_3d_reference(
        grids, normalized, cic_common.orders_from_flat(orders_flat),
        plan=_given_plan(grids.shape[2:], *plan),
    ))


def _gather_kernel(grids, normalized, orders_flat, *plan) -> torch.Tensor:
    """``cic_gather_tiled`` on CUDA tensors: ``gather_tiled_staged_kernel``
    (where a tile's window fits shared memory: the value and raised order
    sets) or ``gather_tiled_kernel`` on the plan's sorted positions, which
    writes the outputs in sorted order, and ``unsort_kernel``, which moves
    them to the original indices through the plan's ``rank``. Counts its
    launch as ``gather_multi_tiled_3d``."""
    orders = cic_common.orders_from_flat(orders_flat)
    histogram_shape = tuple(grids.shape[2:])
    plan = _given_plan(histogram_shape, *plan)
    batch, num_components = grids.shape[:2]
    num_particles = normalized.shape[1]
    out = torch.empty(
        (len(orders), batch, num_components, num_particles),
        dtype=grids.dtype, device=grids.device,
    )
    if batch * num_particles * num_components == 0:
        return out
    grids = grids.contiguous()
    sorted_out = torch.empty_like(out)
    LIBRARY.launch(
        "cic_gather_tiled", grids.dtype, grids.device,
        grids.data_ptr(), plan.sorted_positions.data_ptr(), plan.rank.data_ptr(),
        plan.offsets.data_ptr(), sorted_out.data_ptr(), out.data_ptr(), batch, num_particles,
        num_components, *histogram_shape, plan.rows_per_tile, plan.num_tiles, GATHER_PER_RUN,
        *cic_common.orders_argument(orders),
    )
    cic_common.count_launch(gather_multi_tiled_3d)
    return out


def _gather_fake(grids, normalized, orders_flat, *plan) -> torch.Tensor:
    return grids.new_empty((len(orders_flat) // 3, *grids.shape[:2], normalized.shape[1]))


#: ``cheetah_tpu_torch::cic_gather_tiled``: the x-tiled gather, with the
#: contract of ``cic_gather_multi``, on the tensors of the positions'
#: :class:`TilePlan`.
GATHER_TILED = cic_common.define_operator(
    "cic_gather_tiled",
    f"(Tensor grids, Tensor normalized, int[] orders_flat, {_PLAN_ARGUMENTS}) -> Tensor",
    _gather_plain, _gather_kernel, _gather_fake,
)


def deposit_multi_tiled_3d(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: cic_common.Orders,
    plan: TilePlan | None = None,
) -> torch.Tensor:
    """x-tiled multi-order CIC deposit, with the contract of
    :func:`cheetah_tpu_torch.ops.cic_kernels.deposit_multi_3d`: the
    operator ``cic_deposit_tiled`` (``deposit_tiled_kernel`` on CUDA
    tensors, :func:`deposit_multi_tiled_3d_reference` on CPU tensors) on
    ``plan``, made by :func:`plan_tiles` from ``normalized`` on this grid,
    or made here.
    """
    orders, histogram_shape = cic_common.check_deposit_args(
        normalized, rows, histogram_shape, orders
    )
    if not tiled_bounds_ok(histogram_shape):
        raise ValueError(f"The grid is past the tiled kernels' bounds: {histogram_shape}")
    plan = _check_plan(plan, normalized, histogram_shape)
    return DEPOSIT_TILED(
        normalized, rows, histogram_shape, cic_common.orders_flat(orders), *plan[2:]
    )


deposit_multi_tiled_3d.launches = 0


def gather_multi_tiled_3d(
    grids: torch.Tensor,
    normalized: torch.Tensor,
    orders: cic_common.Orders,
    plan: TilePlan | None = None,
) -> tuple[torch.Tensor, ...]:
    """x-tiled multi-order trilinear gather, with the contract of
    :func:`cheetah_tpu_torch.ops.cic_kernels.gather_multi_3d`: the operator
    ``cic_gather_tiled`` (``gather_tiled_staged_kernel`` or
    ``gather_tiled_kernel``, then ``unsort_kernel``, on CUDA tensors;
    :func:`gather_multi_tiled_3d_reference` on CPU tensors) on ``plan``,
    made by :func:`plan_tiles` from ``normalized`` on this grid, or made
    here.
    """
    orders = cic_common.check_gather_args(grids, normalized, orders)
    histogram_shape = tuple(grids.shape[2:])
    if not tiled_bounds_ok(histogram_shape):
        raise ValueError(f"The grid is past the tiled kernels' bounds: {histogram_shape}")
    plan = _check_plan(plan, normalized, histogram_shape)
    return GATHER_TILED(grids, normalized, cic_common.orders_flat(orders), *plan[2:]).unbind(0)


gather_multi_tiled_3d.launches = 0
