"""What the untiled and the x-tiled CIC kernel pairs share: the orders, as
the C entry points and the operators' schemas take them, the definition of
an operator (:func:`define_operator`), the validation of a deposit's and a
gather's arguments, and the per-corner sums from which both pairs' plain
versions are built.

:mod:`cheetah_tpu_torch.ops.cic_tiled` and
:mod:`cheetah_tpu_torch.ops.cic_kernels` both import this module; it
imports neither of them.

``orders`` is a sequence of up to 8 per-axis derivative orders ``(ox, oy,
ot)`` in ``{0, 1}``: 0 is the hat weight, 1 its a.e. derivative. Positions
are in bin space: corner ``i0 = floor(p)`` weighs ``1 - f`` and ``i0 + 1``
weighs ``f``; corners off the grid, and every corner of a non-finite
position, weigh 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence

import torch

from cheetah_tpu_torch.utils import profiling

Orders = Sequence[tuple[int, int, int]]

#: The single value order, as the space-charge kick uses it.
VALUE = ((0, 0, 0),)

MAX_ORDERS = 8


def check_orders(orders: Orders) -> tuple[tuple[int, int, int], ...]:
    """The orders as a tuple of ``(ox, oy, ot)`` int triples; raises on more
    than :data:`MAX_ORDERS` or on an order other than 0 or 1. The few order
    sets of a path are checked once (the host's time per launch counts)."""
    try:
        return _checked_orders(orders)
    except TypeError:  # unhashable, e.g. a list of lists
        return _checked_orders(tuple(tuple(order) for order in orders))


@functools.lru_cache(maxsize=256)
def _checked_orders(orders) -> tuple[tuple[int, int, int], ...]:
    orders = tuple(tuple(int(v) for v in order) for order in orders)
    if not 1 <= len(orders) <= MAX_ORDERS:
        raise ValueError(f"Between 1 and {MAX_ORDERS} orders are supported: {orders}")
    if any(len(order) != 3 or any(v not in (0, 1) for v in order) for order in orders):
        raise ValueError(f"Orders must be (ox, oy, ot) triples of 0 and 1: {orders}")
    return orders


def orders_flat(orders: Orders) -> tuple[int, ...]:
    """The orders, checked, as the operators' schemas take them: ``3 * O``
    ints, ``(ox, oy, ot)`` of each order in turn."""
    return _flat_of(check_orders(orders))


@functools.lru_cache(maxsize=256)
def _flat_of(orders: tuple[tuple[int, int, int], ...]) -> tuple[int, ...]:
    return tuple(v for order in orders for v in order)


@functools.lru_cache(maxsize=256)
def _orders_of_flat(flat: tuple[int, ...]) -> tuple[tuple[int, int, int], ...]:
    if len(flat) % 3:
        raise ValueError(f"A flat order list holds 3 ints an order: {flat}")
    return check_orders(tuple(zip(flat[0::3], flat[1::3], flat[2::3])))


def orders_from_flat(flat: Sequence[int]) -> tuple[tuple[int, int, int], ...]:
    """The inverse of :func:`orders_flat`, checked as :func:`check_orders`
    checks orders: what an operator's implementation gets back as a tuple
    of triples."""
    return _orders_of_flat(tuple(flat))


@functools.lru_cache(maxsize=256)
def orders_argument(orders: tuple[tuple[int, int, int], ...]) -> tuple[ctypes.c_void_p, int]:
    """The orders (a tuple, as :func:`check_orders` returns them) as the C
    entry points take them: a pointer to ``3 * O`` ints and ``O``. The
    pointer keeps its array alive; the few order sets of a path are made
    once."""
    flat = (ctypes.c_int * (3 * len(orders)))(*(v for order in orders for v in order))
    return ctypes.cast(flat, ctypes.c_void_p), len(orders)


# ---------------------------------------------------------------------------
# Launch geometry and scratch of the fixed-point deposits (csrc/cic_common.cuh)
# ---------------------------------------------------------------------------

#: Threads of a deposit block (``kDepositThreads`` in cic_common.cuh).
DEPOSIT_THREADS = 512
#: Threads an SM runs at most (H100).
_SM_THREADS = 2048
#: Particles one privatised copy (untiled) or one chunk (tiled) deposits at
#: most: a float window of the value order set holds int32 fixed point
#: scaled by the copy's sum of |rows| (``prepare_window`` in
#: cic_common.cuh), so this bounds a term's rounding by 2^-17 of the
#: largest row.
MAX_WINDOW_PARTICLES = 16384
#: Shared memory the card reserves per block beside what a kernel asks for,
#: plus the deposit kernels' static shared memory.
_BLOCK_RESERVE = 1024 + 64
#: Bytes after an int32 window of the tiled deposit in which its cells are
#: converted to int64 for the bulk reduction (``kStageBytes`` in
#: cic_tiled.cu: two buffers of 4096 int64 cells).
STAGE_BYTES = 2 * 4096 * 8


def accumulator_bytes(dtype: torch.dtype, orders: Orders) -> int:
    """Bytes of one cell of a deposit's window in shared memory: 4 (int32
    fixed point) for the value order set in float32, else 8 (int64)."""
    return 4 if dtype == torch.float32 and check_orders(orders) == VALUE else 8


def window_bytes(values: int, accumulator: int, stage: int = 0) -> int:
    """Shared memory of a window of ``values`` cells of ``accumulator``
    bytes, rounded up to 16 bytes, plus ``stage`` bytes (``window_bytes`` in
    cic_common.cuh)."""
    return -(-values * accumulator // 16) * 16 + stage


def fixed_scratch_bytes(grids: int, cells: int) -> int:
    """Bytes of the scratch of a deposit into int64 global grids
    (``FixedScratch`` in cic_common.cuh): ``grids`` grids of ``cells`` int64
    cells, their poison bits (2 bits a cell) and each grid's largest |row|,
    in 8-byte words."""
    values = grids * cells
    return 8 * (values + -(-values // 32) + grids)


class DeviceLimits(NamedTuple):
    """What a deposit's launch is sized from, read once per device."""

    sms: int
    #: Dynamic shared memory a block may take (the opt-in limit less 1 KB).
    budget: int
    #: Shared memory of one SM.
    sm_shared: int


_LIMITS: dict[int, DeviceLimits] = {}


def device_limits(library, device: torch.device) -> DeviceLimits:
    """The limits of the CUDA ``device``, from ``library``'s
    ``cic_device_limits``, read once per device."""
    index = torch.cuda.current_device() if device.index is None else device.index
    limits = _LIMITS.get(index)
    if limits is None:
        values = (ctypes.c_int * 3)()
        library.call("cic_device_limits", index, values)
        limits = _LIMITS[index] = DeviceLimits(*values)
    return limits


def components_per_block(
    values: int, accumulator: int, components: int, budget: int, stage: int = 0
) -> int:
    """How many of ``components`` windows of ``values`` cells each one
    deposit block holds, in one window of ``accumulator``-byte cells
    (:func:`window_bytes`, with ``stage`` bytes after it), in ``budget``
    bytes of shared memory (at most all of them); 0 where not even one
    fits, and the deposit adds to int64 grids in global memory instead."""
    group = min(components, max(0, budget - stage) // (values * accumulator))
    while group and window_bytes(group * values, accumulator, stage) > budget:
        group -= 1
    return group


def resident_blocks(shared: int, limits: DeviceLimits) -> int:
    """Deposit blocks of ``shared`` bytes that the card runs at once."""
    per_sm = min(_SM_THREADS // DEPOSIT_THREADS, limits.sm_shared // (shared + _BLOCK_RESERVE))
    return limits.sms * max(1, per_sm)


def window_blocks(particles: int, limits: DeviceLimits, shared: int) -> int:
    """How many deposit blocks of ``shared`` bytes share ``particles``
    particles (summed over instances and component groups): as many as the
    card runs at once, or, where that leaves a block more than
    :data:`MAX_WINDOW_PARTICLES`, whole waves of them."""
    resident = resident_blocks(shared, limits)
    needed = -(-particles // MAX_WINDOW_PARTICLES)
    return -(-needed // resident) * resident


# ---------------------------------------------------------------------------
# The kernels as operators of the dispatcher
# ---------------------------------------------------------------------------

#: The namespace of the port's operators: ``torch.ops.cheetah_tpu_torch``.
NAMESPACE = "cheetah_tpu_torch"


def count_launch(wrapper: Callable) -> None:
    """Count a CUDA implementation's launch under its wrapper's name in the
    counters of :mod:`cheetah_tpu_torch.utils.profiling`, and in the
    wrapper's ``launches``, which the benchmark's harness
    (``portbench/harness.py``) reads."""
    profiling.count(wrapper.__name__)
    wrapper.launches += 1


def define_operator(
    name: str, schema: str, plain: Callable, kernel: Callable, fake: Callable
) -> torch._ops.OpOverload:
    """The operator ``cheetah_tpu_torch::<name>`` with ``schema``, defined
    with ``torch.library.custom_op`` at the first import of its module.

    ``plain`` is its implementation for CPU tensors (a kernel's plain
    version), ``kernel`` for CUDA tensors (the launch of the hand-written
    kernel) and ``fake`` its fake (meta) implementation, which gives the
    outputs' shapes and dtypes to ``torch.export`` and ``torch.compile``
    (the counterpart of a JAX primitive's abstract evaluation). No other
    implementation is registered: a tensor on another device raises in the
    dispatcher, and a CUDA tensor never reaches a plain version. An
    operator defined already (its module imported again) is returned as
    it is."""
    namespace = getattr(torch.ops, NAMESPACE)
    if not hasattr(namespace, name):
        operator = torch.library.custom_op(
            f"{NAMESPACE}::{name}", plain, mutates_args=(), device_types="cpu", schema=schema
        )
        operator.register_kernel("cuda")(kernel)
        operator.register_fake(fake)
    return getattr(namespace, name).default


def _check_device(*tensors: torch.Tensor) -> str:
    device = tensors[0].device
    if any(tensor.device != device for tensor in tensors):
        raise ValueError("All inputs must lie on the same device.")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"Unsupported device {device}.")
    return device.type


def check_deposit_args(normalized, rows, histogram_shape, orders):
    """Validate a deposit's arguments; returns the orders and the grid shape
    as tuples of ints."""
    orders = check_orders(orders)
    histogram_shape = tuple(int(n) for n in histogram_shape)
    batch, num_orders, _, num_particles = rows.shape
    if normalized.shape != (batch, num_particles, 3) or num_orders != len(orders):
        raise ValueError(
            f"Shapes do not match: normalized {tuple(normalized.shape)}, rows "
            f"{tuple(rows.shape)}, {len(orders)} orders."
        )
    if len(histogram_shape) != 3 or min(histogram_shape) < 1:
        raise ValueError(f"A 3D grid shape is required: {histogram_shape}")
    if normalized.dtype != rows.dtype:
        raise TypeError(f"dtypes differ: {normalized.dtype} and {rows.dtype}")
    _check_device(normalized, rows)
    return orders, histogram_shape


def check_gather_args(grids, normalized, orders):
    """Validate a gather's arguments; returns the orders as a tuple."""
    orders = check_orders(orders)
    if grids.dim() != 5:
        raise ValueError(f"grids must be (B, C, nx, ny, nt): {tuple(grids.shape)}")
    batch, num_particles = grids.shape[0], normalized.shape[1]
    if normalized.shape != (batch, num_particles, 3):
        raise ValueError(
            f"Shapes do not match: grids {tuple(grids.shape)}, normalized "
            f"{tuple(normalized.shape)}."
        )
    if normalized.dtype != grids.dtype:
        raise TypeError(f"dtypes differ: {grids.dtype} and {normalized.dtype}")
    _check_device(grids, normalized)
    return orders


# ---------------------------------------------------------------------------
# Corner sums of the plain versions
# ---------------------------------------------------------------------------


def _axis_corners(position: torch.Tensor, num_bins: int):
    """Per axis: for corners 0 and 1, the clamped integer index, the validity
    mask and, for each order, the weight. Out-of-range and non-finite
    positions give invalid corners; the range is tested in floating point
    before any conversion to int."""
    floor = torch.floor(position)
    frac = position - floor
    corners = []
    for corner in (0, 1):
        index = floor + corner
        valid = (index >= 0) & (index <= num_bins - 1)
        index = torch.where(valid, index, torch.zeros_like(index)).long()
        weights = {
            0: frac if corner else 1.0 - frac,
            1: torch.full_like(frac, 1.0 if corner else -1.0),
        }
        corners.append((index, valid, weights))
    return corners


def _corner_terms(normalized: torch.Tensor, histogram_shape, orders):
    """For each of the 8 corners: the flat cell index ``(B, N)``, the
    validity mask ``(B, N)`` and one weight ``(B, N)`` per order."""
    nx, ny, nt = histogram_shape
    axes = [
        _axis_corners(normalized[..., axis], n)
        for axis, n in enumerate(histogram_shape)
    ]
    for cx in (0, 1):
        ix, vx, wx = axes[0][cx]
        for cy in (0, 1):
            iy, vy, wy = axes[1][cy]
            for ct in (0, 1):
                it, vt, wt = axes[2][ct]
                cell = (ix * ny + iy) * nt + it
                valid = vx & vy & vt
                weights = [wx[ox] * wy[oy] * wt[ot] for ox, oy, ot in orders]
                yield cell, valid, weights


def deposit_cells(normalized, rows, histogram_shape, orders, num_cells, cell_offset=None):
    """``index_add_`` of every corner term into ``(B, C, num_cells)``: the
    deposit into a grid of ``histogram_shape`` cells, shifted by
    ``cell_offset (B, N)`` per particle when given (the tiled plain version
    deposits each particle into its tile's window this way)."""
    batch, num_orders, num_components, num_particles = rows.shape
    out = torch.zeros(
        batch * num_components * num_cells, dtype=rows.dtype, device=rows.device
    )
    base = (
        torch.arange(batch * num_components, device=rows.device).view(
            batch, num_components, 1
        )
        * num_cells
    )
    for cell, valid, weights in _corner_terms(normalized, histogram_shape, orders):
        if cell_offset is not None:
            cell = cell + cell_offset
        value = sum(rows[:, o] * weights[o][:, None, :] for o in range(num_orders))
        value = torch.where(valid[:, None, :], value, torch.zeros_like(value))
        index = base + cell[:, None, :]
        out.index_add_(0, index.reshape(-1), value.reshape(-1))
    return out.view(batch, num_components, num_cells)


def gather_cells(flat, normalized, histogram_shape, orders, cell_offset=None):
    """Flat ``gather`` of every corner from ``flat (B, C, M)``: the gather
    from a grid of ``histogram_shape`` cells, shifted by ``cell_offset (B,
    N)`` per particle when given."""
    batch, num_components = flat.shape[:2]
    outs = [
        torch.zeros(
            batch, num_components, normalized.shape[1], dtype=flat.dtype, device=flat.device
        )
        for _ in orders
    ]
    for cell, valid, weights in _corner_terms(normalized, histogram_shape, orders):
        if cell_offset is not None:
            cell = cell + cell_offset
        index = cell[:, None, :].expand(batch, num_components, -1)
        value = torch.gather(flat, 2, index)
        for out, weight in zip(outs, weights):
            term = weight[:, None, :] * value
            out += torch.where(valid[:, None, :], term, torch.zeros_like(term))
    return tuple(outs)
