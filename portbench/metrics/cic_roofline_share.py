"""The CIC kernels' share of their roofline in a space-charge step, in
percent: the least time the step's cloud-in-cell work needs on the card
over the device time of the port's CIC kernels.

The work is that of the operators' contracts at the cell's shapes, each
input read once and each output written once, whatever implements it
(the byte and operation counts of the kernels' checks on the card). A
space-charge kick on ``N`` particles and a grid of ``M`` cells calls,
forward, the deposit of the charge (1 order, 1 component) and the gather
of the three force fields (1 order, 3 components); its backward, the
deposit of the force gradients (1 order, 3 components), the gather of the
force fields at the three raised orders for the positions' gradient (3
orders, 3 components) and the gather of the charge grid's gradient at the
raised orders (3 orders, 1 component). Each tile plan the step calls (the
port's counter ``plan_tiles.launches``) adds its own work. The least time
of each call is the larger of its bytes over the HBM bandwidth and its
operations over the float32 rate; the share sums them.
"""

from __future__ import annotations

import math

from portbench import peaks

#: Pieces of the names of the port's CIC kernels (csrc/).
CIC_KERNELS = (
    "gather_multi_kernel", "gather_staged_kernel", "gather_tiled_kernel",
    "gather_tiled_staged_kernel", "unsort_kernel", "deposit_multi_kernel",
    "deposit_private_kernel", "deposit_reduce_kernel", "deposit_tiled_kernel",
    "row_max_kernel", "fixed_to_output_kernel", "plan_count_kernel", "plan_scan_kernel",
    "plan_scatter_kernel",
)
#: Bytes of a float32 value.
FLOAT = 4


def deposit_work(particles: int, cells: int, orders: int, components: int) -> tuple[int, int]:
    """Bytes and operations of a deposit: positions and rows read once, the
    grids written once; 8 corners of 5 operations for each row."""
    return (FLOAT * (particles * (3 + orders * components) + components * cells),
            particles * 8 * 5 * orders * components)


def gather_work(particles: int, cells: int, orders: int, components: int) -> tuple[int, int]:
    """Bytes and operations of a gather: grids and positions read once, the
    ``orders * components`` outputs written once; 8 corners of 4
    operations for each output."""
    return (FLOAT * (components * cells + particles * (3 + orders * components)),
            particles * components * 8 * 4 * orders)


def plan_work(particles: int) -> tuple[int, int]:
    """Bytes and operations of a tile plan: the positions read, the
    permutation (8 B), the tile (4 B) and the sorted positions written once
    a particle."""
    return particles * (3 * 4 + 8 + 4 + 3 * 4), particles * 4


def step_calls(particles: int, cells: int, kicks: int, backward: bool) -> list[tuple[str, int, int]]:
    """``(kind, bytes, operations)`` of each deposit and gather of a step."""
    calls = []
    for _ in range(kicks):
        calls.append(("deposit", *deposit_work(particles, cells, 1, 1)))
        calls.append(("gather", *gather_work(particles, cells, 1, 3)))
        if backward:
            calls.append(("deposit", *deposit_work(particles, cells, 1, 3)))
            calls.append(("gather", *gather_work(particles, cells, 3, 3)))
            calls.append(("gather", *gather_work(particles, cells, 3, 1)))
    return calls


def least_seconds(trace) -> tuple[float, str] | None:
    """The least time of a step's CIC work and what bounds most of it, or
    ``None`` for a cell without a space-charge kick."""
    kicks = [e for e in trace.config.get("lattice", []) if e["type"] == "SpaceChargeKick"]
    if not kicks:
        return None
    particles = int(trace.config["beam"]["num_particles"])
    cells = math.prod(kicks[0]["grid_shape"])
    backward = trace.traffic.get("entry") == "track_grad"
    calls = step_calls(particles, cells, len(kicks), backward)
    plans = trace.counters.get("plan_tiles", 0) / trace.steps
    calls.append(("plan", plans * plan_work(particles)[0], plans * plan_work(particles)[1]))
    bounds = [peaks.bound(size, operations) for _, size, operations in calls]
    by_bytes = sum(seconds for seconds, by in bounds if by == "bytes")
    total = sum(seconds for seconds, _ in bounds)
    return total, "bytes" if by_bytes >= total / 2 else "operations"


def read(trace):
    least = least_seconds(trace)
    cic = [op for op in trace.kernels if any(piece in op.name for piece in CIC_KERNELS)]
    if least is None or not cic:
        return None
    return 100.0 * least[0] / (sum(op.seconds for op in cic) / trace.steps)


def note(trace) -> dict:
    """The least time a step and the bound that sets it."""
    seconds, by = least_seconds(trace)
    return {"least_ms_per_step": seconds * 1e3, "bound_by": by}
