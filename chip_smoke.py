#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cheetah_tpu_torch``) on one NVIDIA card.

Run from the root of the repository with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``cheetah_tpu_torch/csrc`` with nvcc (one
process per source, all at once, reporting ptxas's registers per kernel),
holds each kernel against its plain PyTorch version on the card (and the
tile plan's counting sort against ``torch.sort``), the deposits on every
route their wrappers pick and on a crowded beam, times the gathers at the
order sets the paths use and the deposits at C = 1 and 3, drives the paths
of the port through the
public entry points (the ARES EA env step and the 1M-particle space-charge
segment, forward and with their gradients, the latter on the 32^3 grid of
the untiled kernels and the 128^3 grid of the x-tiled ones), checks them
against the port's own float64 run on the CPU and a float64 finite
difference on the card, and times kernels and paths with CUDA events.
Every phase prints one JSON line. The last line is
``{"ok": true, "device": {...}}``; any failed check raises, so the script
exits non-zero and prints no such line. It imports neither JAX nor the JAX
package, and it refuses to run without a card.

Precision: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False, so float32 matrix
products run in full float32.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time

import torch

#: Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

NUM_PARTICLES = 1_000_000
ALL_ORDERS = tuple(itertools.product((0, 1), repeat=3))
SEED = 0
#: The order sets the paths ask the gather for (the forward kick; the
#: raised set of both backward passes), with their component counts.
RAISED = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
PATH_ORDER_SETS = [("value_c3", ((0, 0, 0),), 3), ("raised_c3", RAISED, 3),
                   ("raised_c1", RAISED, 1)]

# Tolerances of the kernels against their plain versions on the card, as a
# fraction of max|output|. The gather sums 8 corner terms per output in the
# same order as its plain version; only FMA contraction differs, a few ulps.
# The deposit adds ~N * 8 / cells (~250 at 32^3) terms per cell with
# atomics in an order that changes from run to run, as does index_add_ in
# the plain version; sqrt(250) * eps * max|term| stays well below 1e-5 of
# max|output|, and K * eps * max|term| (the worst case) near it. At the
# value order set in float32 the privatised deposits add in int32 fixed
# point, each term rounded by at most 2^-17 of the largest row (16384
# particles a copy, csrc/cic_common.cuh); random roundings over K terms
# stay below 1e-4 of max|output| even where signed rows cancel in a cell.
GATHER_TOLERANCE = 1e-5
DEPOSIT_TOLERANCE = 1e-4
# The card (float32) against the port on the CPU (float64): sigma_x of the
# env step to rtol 1e-4 (a 13-matrix product and a raw-moment variance over
# 10k particles in float32, ~1e-6 expected); the space-charge kicks to an RMS
# error of 1e-4 of the RMS kick in px and py (float32 deposit rounding and
# grid edges that move with float32 beam sizes, ~2e-6 on the CPU at 200k
# particles) and 1e-3 in p, where the float32 SI round trip adds
# eps * gamma0 / (beta0 gamma0) = 6e-8 per particle (~1.5e-5 on the CPU).
ENV_STEP_RTOL = 1e-4
KICK_RMS_TOLERANCE = {"px": 1e-4, "py": 1e-4, "p": 1e-3}
# Gradients. d sum(px^2) / d(drift length) sums a signed term per particle
# with heavy cancellation, so float32 keeps fewer digits of it than of the
# kicks, and fewer on a finer grid, with fewer particles per cell: on one
# H100 this script measured the float32 gradient 2.6e-6 to 1.4e-5 (32^3)
# and 2.3e-4 to 2.8e-4 (128^3) off the float64 CPU gradient. The card's
# float64 gradient differs from the CPU's in summation order only (atomics,
# FFT), amplified by the same cancellation (2e-13 measured). The float64
# central difference on the card (step 1e-6 of the 0.1 m drift) differs
# from the a.e. derivative where particles cross cell edges inside the
# step, by O(step / cell) relative (2e-5 measured at 128^3).
SC_GRAD_F32_RTOL = {(32, 32, 32): 1e-3, (128, 128, 128): 1e-2}
SC_GRAD_F64_RTOL = 1e-8
SC_GRAD_FD_STEP = 1e-6
SC_GRAD_FD_RTOL = 1e-4
# The env step's k1 gradient on the card (float32) against the CPU
# (float64), relative to the largest gradient entry: a 13-matrix product
# and a raw-moment variance in float32, as for sigma_x (1.8e-6 measured).
ENV_GRAD_TOLERANCE = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def time_ms(fn, runs: int = 20, warmup: int = 3, per_event: int = 1) -> float:
    """Median time of one call of ``fn`` on the card, with CUDA events around
    ``per_event`` back-to-back calls, over ``runs`` such windows. A kernel is
    timed with ``per_event`` > 1, so that the host's time to enqueue one call
    hides behind the previous call instead of counting as device time; a
    whole path is timed call by call, as its user calls it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_event):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_event)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, runs: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` back-to-back calls
    captured in a CUDA graph, replayed ``runs`` times between CUDA events
    (median). Unlike :func:`time_ms`, the host's time to enqueue a call does
    not count, so a kernel faster than its wrapper's Python is timed as the
    card runs it; a library call is timed the same way."""
    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, runs=runs, warmup=2) / calls
    del graph
    return ms


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it."""
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = operations / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def relative_error(actual: torch.Tensor, expected: torch.Tensor) -> tuple[float, float]:
    """(max |actual - expected|, that divided by max |expected|)."""
    absolute = (actual.double() - expected.double()).abs().max().item()
    return absolute, absolute / expected.double().abs().max().item()


#: Device-time families of the port's kernels in a profile, by a piece of
#: the kernel's name.
KERNEL_FAMILIES = {
    "gather": ("gather_multi_kernel", "gather_staged_kernel", "gather_tiled_kernel",
               "gather_tiled_staged_kernel", "unsort_kernel"),
    "deposit": ("deposit_multi_kernel", "deposit_private_kernel", "deposit_reduce_kernel",
                "deposit_tiled_kernel"),
    "plan": ("plan_count_kernel", "plan_scan_kernel", "plan_scatter_kernel"),
}


def profile_path(label: str, fn, ms: float) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``), and
    the device's idle share against ``ms``, the call's CUDA-event time.
    Returns the CIC kernels' device time and launches by family."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: a CPU op's entry repeats the device time of
    # the kernels it launched.
    kernels = [
        e
        for e in trace.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    families = {
        family: {
            "ms": sum(e.self_device_time_total for e in members) / 1e3,
            "count": sum(e.count for e in members),
        }
        for family, pieces in KERNEL_FAMILIES.items()
        for members in [[e for e in kernels if any(piece in e.key for piece in pieces)]]
    }
    emit(
        "profile",
        path=label,
        event_ms=ms,
        device_busy_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / ms),
        kernel_launches=sum(e.count for e in kernels),
        cic_kernels=families,
        top=[
            {"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
            for e in top
        ],
    )
    return families


# The kernel wrappers, each with its own launch count: the untiled pair,
# and the tiled pair with its plan.
def _wrappers(cic_kernels, cic_tiled) -> dict:
    return {
        "deposit_multi_3d": cic_kernels.deposit_multi_3d,
        "gather_multi_3d": cic_kernels.gather_multi_3d,
        "deposit_multi_tiled_3d": cic_tiled.deposit_multi_tiled_3d,
        "gather_multi_tiled_3d": cic_tiled.gather_multi_tiled_3d,
        "plan_tiles": cic_tiled.plan_tiles,
    }


TILED_WRAPPERS = ("deposit_multi_tiled_3d", "gather_multi_tiled_3d", "plan_tiles")


def _reset_launches(wrappers: dict) -> None:
    for wrapper in wrappers.values():
        wrapper.launches = 0


def _launches(wrappers: dict) -> dict:
    torch.cuda.synchronize()
    return {name: wrapper.launches for name, wrapper in wrappers.items()}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        "environment",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        nvidia_smi=smi,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
    )
    return smi


def _ptxas_usage(output: str) -> dict:
    """Registers and spill stores of each kernel, from ``ptxas -v`` output,
    by demangled name without its argument list."""
    usage, mangled = {}, []
    current = None
    for line in output.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            mangled.append(current)
            usage[current] = {"registers": None, "spill_stores": None}
        elif current and "bytes spill stores" in line:
            usage[current]["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif current and "Used" in line and "registers" in line:
            usage[current]["registers"] = int(line.split("Used")[1].split("registers")[0])
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(mangled), capture_output=True, text=True, timeout=60,
            check=True,
        ).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = mangled
    if len(names) != len(mangled):
        names = mangled
    short = {}
    for raw, name in zip(mangled, names):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        short[name.split("(", 1)[0]] = [usage[raw]["registers"], usage[raw]["spill_stores"]]
    return short


def phase_build(libraries) -> None:
    from cheetah_tpu_torch.ops import nvcc

    start = time.perf_counter()
    outputs = nvcc.build_all(libraries, verbose=True)
    seconds = time.perf_counter() - start
    # [registers, spill stores] of every kernel instantiation; gather
    # instantiations are <T, index type, order kind (0 generic, 1 value,
    # 2 raised), orders, components (0: at run time)>.
    usage = {source: _ptxas_usage(output) for source, output in outputs.items()}
    emit(
        "build", seconds=seconds,
        libraries=[str(library.path()) for library in libraries],
        ptxas_registers_spills=usage,
    )
    check(all(usage.values()), "ptxas reported no kernels")


def _uniform_positions(generator, batch, shape, dtype):
    """Bin-space positions spilling past every edge, with parked (-2),
    far-out and non-finite particles mixed in."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    normalized = (
        torch.rand((batch, NUM_PARTICLES, 3), generator=generator, dtype=dtype, device="cuda")
        * (n + 2.0)
        - 1.5
    )
    normalized[:, ::97] = -2.0
    normalized[:, 1::1009, 0] = float("nan")
    normalized[:, 2::1009, 1] = float("inf")
    normalized[:, 3::1009, 2] = -1e30
    return normalized


def _beam_positions(generator, shape, offset, dtype):
    """Bin-space positions of a Gaussian beam on a grid of +-3 sigma, as the
    space-charge kick gives them (``offset`` -0.5 for the deposit's cell
    centres, 0 for the gather's nodes)."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    gauss = torch.randn((1, NUM_PARTICLES, 3), generator=generator, dtype=dtype, device="cuda")
    return n / 2 + offset + gauss * n / 6


def _crowded_positions(generator, batch, shape, dtype, count=NUM_PARTICLES):
    """Bin-space positions of every particle inside the 2 x 2 x 2 cells at
    the grid's centre: each cell gets ~N / 8 particles' atomics, the worst
    case for a privatised deposit's shared-memory atomics."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    jitter = torch.rand((batch, count, 3), generator=generator, dtype=dtype, device="cuda")
    return torch.floor(n / 2) - 1 + 2 * jitter


def _deposit_route(cic_kernels, cic_tiled, shape, dtype, batch, components) -> str:
    """Which kernel a deposit of this call launches, as the wrappers choose
    it: the privatised untiled kernel with its copies, the global-atomic
    untiled kernel, or the x-tiled kernel with its chunk length, with or
    without windows."""
    from cheetah_tpu_torch.ops import cic_common

    itemsize = torch.empty((), dtype=dtype).element_size()
    limits = cic_common.device_limits(cic_kernels.LIBRARY, torch.device("cuda"))
    if cic_kernels.uses_tiled(shape):
        window = (cic_tiled.rows_per_tile(shape) + 1) * shape[1] * shape[2]
        g = cic_tiled.tiled_deposit_geometry(batch, components, NUM_PARTICLES, window, itemsize,
                                             limits)
        windows = "windows" if g.shared else "no windows"
        return f"tiled group={g.group} per_run={g.per_run} {windows}"
    g = cic_kernels.untiled_deposit_geometry(batch, components, NUM_PARTICLES,
                                             shape[0] * shape[1] * shape[2], itemsize, limits)
    if g is None:
        return "untiled global atomics"
    return f"untiled private group={g.group} copies={g.copies}"


def _crowded_deposit_errors(cic_kernels, cic_tiled, generator) -> list:
    """The deposits on crowded inputs (:func:`_crowded_positions`), on each
    privatised route, at the value order (C = 1 and 3) and all 8 orders:
    the worst relative error against the plain version per case."""
    cases = [((32, 32, 32), torch.float32), ((32, 32, 32), torch.float64),
             ((64, 64, 64), torch.float32), ((128, 128, 128), torch.float32),
             ((128, 128, 128), torch.float64)]
    results = []
    for shape, dtype in cases:
        normalized = _crowded_positions(generator, 1, shape, dtype)
        for orders, components in ((cic_kernels.VALUE, 1), (cic_kernels.VALUE, 3),
                                   (ALL_ORDERS, 1)):
            rows = torch.randn((1, len(orders), components, NUM_PARTICLES), generator=generator,
                               dtype=dtype, device="cuda")
            got = cic_kernels.deposit_multi_3d(normalized, rows, shape, orders)
            if cic_kernels.uses_tiled(shape):
                want = cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, orders)
            else:
                want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, orders)
            error = relative_error(got, want)[1]
            results.append({
                "grid": list(shape), "dtype": str(dtype).removeprefix("torch."),
                "orders": len(orders), "components": components, "rel_err": error,
                "route": _deposit_route(cic_kernels, cic_tiled, shape, dtype, 1, components),
            })
            check(error <= DEPOSIT_TOLERANCE, f"crowded deposit {results[-1]}: error {error}")
        del normalized, rows, got, want
    return results


def _unaligned(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``tensor`` whose data starts one element past an
    aligned address. A bulk copy needs 16-byte alignment, so the gathers
    read such a grid through L1 and L2 even where a staged gather would
    serve it: the way to check and time their other route."""
    buffer = torch.empty(tensor.numel() + 1, dtype=tensor.dtype, device=tensor.device)
    view = buffer[1:].view(tensor.shape)
    view.copy_(tensor)
    return view


def _path_sets_error(gather, plain, grids, normalized) -> float:
    """Worst relative error of a gather against its plain version over the
    path's order sets (components 3 and 1 of ``grids``), on the route the
    gather picks for the grid and on the L1/L2 route (:func:`_unaligned`)."""
    worst = 0.0
    for _, orders, components in PATH_ORDER_SETS:
        values = grids[:, :components].contiguous()
        want = plain(values, normalized, orders)
        for given in (values, _unaligned(values)):
            got = gather(given, normalized, orders)
            worst = max(worst, *(relative_error(g, w)[1] for g, w in zip(got, want)))
    return worst


def _large_batch_error(cic_kernels) -> float:
    """The untiled gather on more instances than a grid's y dimension takes
    (65535): it runs on the L1/L2 kernel's 1-D grid. Worst relative error
    against the plain version over the path's order sets and all 8."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch, shape = 70_000, (4, 4, 4)
    n = torch.tensor(shape, dtype=torch.float32, device="cuda")
    normalized = torch.rand((batch, 8, 3), generator=generator, device="cuda") * (n + 2) - 1.5
    grids = torch.randn((batch, 3, *shape), generator=generator, device="cuda")
    worst = _path_sets_error(
        cic_kernels.gather_multi_3d, cic_kernels.gather_multi_3d_reference, grids, normalized
    )
    got = cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS)
    want = cic_kernels.gather_multi_3d_reference(grids, normalized, ALL_ORDERS)
    return max(worst, *(relative_error(g, w)[1] for g, w in zip(got, want)))


def phase_kernels(cic_kernels) -> dict:
    """Each kernel against its plain version on the card, at all 8 orders
    for B in {1, 4} and grids 32^3 and 64^3, then timed at the main path's
    shape. Returns the numbers for the ``kernels`` line."""
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"deposit": 0.0, "gather": 0.0}
    for batch, side, dtype in [
        (1, 32, torch.float32), (4, 32, torch.float32),
        (1, 64, torch.float32), (4, 64, torch.float32),
        (1, 32, torch.float64), (4, 32, torch.float64), (1, 64, torch.float64),
    ]:
        shape = (side, side, side)
        normalized = _uniform_positions(generator, batch, shape, dtype)
        rows = torch.randn(
            (batch, len(ALL_ORDERS), 1, NUM_PARTICLES), generator=generator,
            dtype=dtype, device="cuda",
        )
        got = cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS)
        want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, ALL_ORDERS)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "deposit produced non-finite values")
        _, deposit_error = relative_error(got, want)
        ms_deposit = time_ms(
            lambda: cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS),
            per_event=10,
        )

        grids = torch.randn(
            (batch, 3, *shape), generator=generator, dtype=dtype, device="cuda"
        )
        got = cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS)
        want = cic_kernels.gather_multi_3d_reference(grids, normalized, ALL_ORDERS)
        torch.cuda.synchronize()
        gather_error = max(relative_error(g, w)[1] for g, w in zip(got, want))
        check(all(bool(torch.isfinite(g).all()) for g in got), "gather produced non-finite values")
        path_sets_error = _path_sets_error(
            cic_kernels.gather_multi_3d, cic_kernels.gather_multi_3d_reference, grids, normalized
        )
        check(path_sets_error <= GATHER_TOLERANCE, f"gather error {path_sets_error} (path sets)")
        ms_gather = time_ms(
            lambda: cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS), per_event=10
        )
        # Bytes each kernel must move: positions, rows or grids read once,
        # outputs written once.
        size = normalized.element_size()
        cells = side**3
        orders = len(ALL_ORDERS)
        deposit_bytes = size * batch * (NUM_PARTICLES * (3 + orders) + cells)
        gather_bytes = size * batch * (3 * cells + NUM_PARTICLES * (3 + 3 * orders))
        emit(
            "kernel_check",
            batch=batch, grid=list(shape), particles=NUM_PARTICLES, orders=orders,
            dtype=str(dtype).removeprefix("torch."),
            deposit_rel_err=deposit_error, deposit_ms=ms_deposit,
            deposit_route=_deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, dtype, batch, 1),
            deposit_bound_ms=bound(deposit_bytes, batch * NUM_PARTICLES * 8 * 5 * orders)[0],
            gather_components=3, gather_rel_err=gather_error, gather_ms=ms_gather,
            gather_path_sets_rel_err=path_sets_error,
            gather_bound_ms=bound(gather_bytes, batch * NUM_PARTICLES * 3 * 8 * 4 * orders)[0],
        )
        check(deposit_error <= DEPOSIT_TOLERANCE, f"deposit error {deposit_error}")
        check(gather_error <= GATHER_TOLERANCE, f"gather error {gather_error}")
        worst["deposit"] = max(worst["deposit"], deposit_error)
        worst["gather"] = max(worst["gather"], gather_error)
        del normalized, rows, grids, got, want

    large_batch_error = _large_batch_error(cic_kernels)
    emit("gather_large_batch", batch=70_000, grid=[4, 4, 4], particles=8,
         rel_err=large_batch_error)
    check(large_batch_error <= GATHER_TOLERANCE, f"gather error {large_batch_error} at B 70000")

    # The main path's shape: one instance, 32^3, 1M particles, the value
    # order; the deposit carries the charge (C=1), the gather the three
    # force components (C=3).
    shape = (32, 32, 32)
    f32 = torch.float32
    cells = shape[0] * shape[1] * shape[2]
    positions = _beam_positions(generator, shape, -0.5, f32)
    charges = torch.rand((1, 1, 1, NUM_PARTICLES), generator=generator, dtype=f32, device="cuda")
    got = cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE)
    want = cic_kernels.deposit_multi_3d_reference(positions, charges, shape, cic_kernels.VALUE)
    deposit_abs, deposit_rel = relative_error(got, want)
    check(deposit_rel <= DEPOSIT_TOLERANCE, f"deposit error {deposit_rel} at the main shape")
    deposit_ms = graph_ms(
        lambda: cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE)
    )
    deposit_eager_ms = time_ms(
        lambda: cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE),
        per_event=10,
    )
    deposit_plain_ms = time_ms(
        lambda: cic_kernels.deposit_multi_3d_reference(positions, charges, shape, cic_kernels.VALUE),
        per_event=10,
    )
    deposit_bound = bound(
        NUM_PARTICLES * (3 + 1) * 4 + cells * 4, NUM_PARTICLES * 8 * 5
    )
    deposit_c3 = _deposit_c3(cic_kernels.deposit_multi_3d, cic_kernels.deposit_multi_3d_reference,
                             generator, positions, shape)
    deposit_c3["route"] = _deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, f32, 1, 3)

    nodes = _beam_positions(generator, shape, 0.0, f32)
    grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
    (got,) = cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE)
    (want,) = cic_kernels.gather_multi_3d_reference(grids, nodes, cic_kernels.VALUE)
    gather_abs, gather_rel = relative_error(got, want)
    check(gather_rel <= GATHER_TOLERANCE, f"gather error {gather_rel} at the main shape")
    gather_ms = graph_ms(lambda: cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE))
    gather_eager_ms = time_ms(
        lambda: cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE), per_event=10
    )
    gather_plain_ms = time_ms(
        lambda: cic_kernels.gather_multi_3d_reference(grids, nodes, cic_kernels.VALUE),
        per_event=10,
    )
    gather_bound = bound(
        cells * 3 * 4 + NUM_PARTICLES * 3 * 4 + NUM_PARTICLES * 3 * 4,
        NUM_PARTICLES * 3 * 8 * 4,
    )

    # Yardstick, timed only: grid_sample (trilinear, zero padding) computes
    # the order-0 gather in one call. Its input is (B, C, D, H, W) = (1, 3,
    # nx, ny, nt) and its grid's last axis is (t, y, x) scaled to [-1, 1].
    scale = torch.tensor([shape[2] - 1, shape[1] - 1, shape[0] - 1], dtype=f32, device="cuda")
    sample_grid = (nodes.flip(-1) / scale * 2 - 1).view(1, 1, 1, NUM_PARTICLES, 3)

    def library_gather():
        return torch.nn.functional.grid_sample(
            grids, sample_grid, mode="bilinear", padding_mode="zeros", align_corners=True
        )

    library = library_gather().view(1, 3, NUM_PARTICLES)
    _, library_rel = relative_error(library, want)
    gather_library_ms = graph_ms(library_gather)
    gather_library_eager_ms = time_ms(library_gather, per_event=10)

    emit(
        "kernel_main_shape",
        grid=list(shape), particles=NUM_PARTICLES,
        deposit={"ms": deposit_ms, "eager_ms": deposit_eager_ms, "plain_ms": deposit_plain_ms,
                 "bound_ms": deposit_bound[0], "max_abs_err": deposit_abs, "rel_err": deposit_rel,
                 "route": _deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, f32, 1, 1)},
        deposit_c3=deposit_c3,
        gather={"ms": gather_ms, "eager_ms": gather_eager_ms, "plain_ms": gather_plain_ms,
                "bound_ms": gather_bound[0], "library_ms": gather_library_ms,
                "library_eager_ms": gather_library_eager_ms, "grid_sample_rel_diff": library_rel,
                "max_abs_err": gather_abs, "rel_err": gather_rel},
        worst_rel_err_all_orders=worst,
    )
    return {
        "deposit": dict(
            ms=deposit_ms, eager_ms=deposit_eager_ms, plain_ms=deposit_plain_ms,
            bound_ms=deposit_bound[0], bound_by=deposit_bound[1], library_ms=None,
            max_abs_err=deposit_abs, c3_ms=deposit_c3["ms"], c3_bound_ms=deposit_c3["bound_ms"],
        ),
        "gather": dict(
            ms=gather_ms, eager_ms=gather_eager_ms, plain_ms=gather_plain_ms,
            bound_ms=gather_bound[0], bound_by=gather_bound[1], library_ms=gather_library_ms,
            max_abs_err=gather_abs,
        ),
    }


def _deposit_c3(deposit, plain, generator, positions, shape, **plan) -> dict:
    """The deposit at the backward shape (the value order, C = 3: the
    transpose of the force gather) on the main path's positions, against
    its plain version, timed, with its bound: positions and rows read once,
    the three grids written once."""
    cells = shape[0] * shape[1] * shape[2]
    value = ((0, 0, 0),)
    forces = torch.randn((1, 1, 3, NUM_PARTICLES), generator=generator, dtype=positions.dtype,
                         device="cuda")
    got = deposit(positions, forces, shape, value, **plan)
    absolute, rel = relative_error(got, plain(positions, forces, shape, value))
    check(rel <= DEPOSIT_TOLERANCE, f"{shape}: deposit error {rel} at C=3")
    return {
        "ms": graph_ms(lambda: deposit(positions, forces, shape, value, **plan)),
        "eager_ms": time_ms(lambda: deposit(positions, forces, shape, value, **plan),
                            per_event=10),
        "plain_ms": time_ms(lambda: plain(positions, forces, shape, value), per_event=10),
        "bound_ms": bound(NUM_PARTICLES * (3 + 3) * 4 + 3 * cells * 4,
                          NUM_PARTICLES * 8 * 5 * 3)[0],
        "max_abs_err": absolute, "rel_err": rel,
    }


def _bench_beam(ctt, num_particles, device, generator):
    """The Twiss beam of the JAX package's benchmarks (``bench.py``)."""
    return ctt.ParticleBeam.from_twiss(
        num_particles=num_particles, beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9,
        beta_y=3.0, alpha_y=0.5, emittance_y=2e-9, energy=1.54e8, total_charge=1e-10,
        generator=generator, dtype=torch.float32, device=device,
    )


def phase_env_step(ctt, wrappers) -> None:
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances, num_particles = 4096, 10_000
    segment = ares_ea_subcell(torch.float32)
    segment.AREAMQZM1.k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, num_particles, "cuda", generator)
    num_elements = len(segment.elements)

    _reset_launches(wrappers)
    sigma_x = segment.track(beam).sigma_x
    launches = _launches(wrappers)
    check(not any(launches.values()), f"the env step launched {launches}")
    check(tuple(sigma_x.shape) == (num_instances,), f"sigma_x shape {tuple(sigma_x.shape)}")
    check(bool(torch.isfinite(sigma_x).all()), "non-finite sigma_x")

    picks = torch.linspace(0, num_instances - 1, 8).round().long()
    reference = ares_ea_subcell(torch.float64, device="cpu")
    reference.AREAMQZM1.k1 = segment.AREAMQZM1.k1[picks.cuda()].cpu().double()
    expected = reference.track(beam.to("cpu", torch.float64)).sigma_x
    actual = sigma_x[picks.cuda()].cpu().double()
    error = ((actual - expected).abs() / expected).max().item()
    check(error <= ENV_STEP_RTOL, f"env step sigma_x off by {error} relative")

    ms = time_ms(lambda: segment.track(beam).sigma_x, runs=20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_path("env_step", lambda: segment.track(beam).sigma_x, ms)
    emit(
        "env_step",
        instances=num_instances, particles=num_particles, elements=num_elements,
        ms=ms, transports_per_s=num_instances * num_particles * num_elements / (ms * 1e-3),
        sigma_x_rel_err_vs_cpu_f64=error, kernel_launches=launches,
        peak_memory_gib=peak,
    )


def _sc_segment(ctt, dtype, device, grid_shape=(32, 32, 32)):
    """The space-charge segment of the JAX package's benchmark
    (``scripts/bench_all.py:415-424``): Drift-Kick-Drift-Kick-Drift, on a
    32^3 grid unless ``grid_shape`` says otherwise."""
    kw = {"dtype": dtype, "device": device}
    return ctt.Segment(
        [
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, **kw),
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, **kw),
            ctt.Drift(0.1, **kw),
        ]
    )


def _check_kicks(label, beam_in, out_card, out_cpu) -> dict:
    before = beam_in.to("cpu", torch.float64).particles
    errors = {}
    for index, name in ((1, "px"), (3, "py"), (5, "p")):
        kick_cpu = out_cpu.particles[..., index] - before[..., index]
        kick_card = out_card.particles[..., index].cpu().double() - before[..., index]
        rms = torch.sqrt(torch.mean(kick_cpu**2)).item()
        error = torch.sqrt(torch.mean((kick_card - kick_cpu) ** 2)).item() / rms
        errors[name] = error
        check(error <= KICK_RMS_TOLERANCE[name], f"{label}: {name} kick off by {error} RMS")
    return errors


def phase_space_charge(ctt, wrappers) -> dict:
    """The 32^3 segment's forward on the card: only the untiled pair
    launches, once per kick each, and the kicks match the port's float64
    CPU run; then one 64^3 kick. Returns the segment's launches."""
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
    segment = _sc_segment(ctt, torch.float32, "cuda")

    _reset_launches(wrappers)
    out = segment.track(beam)
    launches = _launches(wrappers)
    expected = {name: 0 for name in wrappers} | {"deposit_multi_3d": 2, "gather_multi_3d": 2}
    check(launches == expected, f"space-charge segment launched {launches}, not {expected}")
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles after the kicks")

    start = time.perf_counter()
    out_cpu = _sc_segment(ctt, torch.float64, "cpu").track(beam.to("cpu", torch.float64))
    cpu_seconds = time.perf_counter() - start
    errors = _check_kicks("segment", beam, out, out_cpu)
    ms = time_ms(lambda: segment.track(beam), runs=10)
    profile_path("space_charge_segment", lambda: segment.track(beam), ms)
    emit(
        "space_charge_segment",
        particles=NUM_PARTICLES, grid=[32, 32, 32], kicks=2, ms=ms,
        launches=launches,
        kick_rms_rel_err_vs_cpu_f64=errors, cpu_f64_seconds=cpu_seconds,
    )

    kick = ctt.SpaceChargeKick(0.5, grid_shape=(64, 64, 64), dtype=torch.float32)
    _reset_launches(wrappers)
    out = kick.track(beam)
    kick_launches = _launches(wrappers)
    check(
        kick_launches == expected | {"deposit_multi_3d": 1, "gather_multi_3d": 1},
        f"the 64^3 kick launched {kick_launches}, not each untiled kernel once",
    )
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles after the 64^3 kick")
    kick_cpu = ctt.SpaceChargeKick(0.5, grid_shape=(64, 64, 64), dtype=torch.float64, device="cpu")
    errors = _check_kicks("64^3 kick", beam, out, kick_cpu.track(beam.to("cpu", torch.float64)))
    emit(
        "space_charge_kick_64",
        particles=NUM_PARTICLES, grid=[64, 64, 64], ms=time_ms(lambda: kick.track(beam), runs=10),
        kick_rms_rel_err_vs_cpu_f64=errors,
    )
    return launches


TILED_SHAPES = [(128, 128, 128), (128, 128, 64), (160, 40, 16)]


def _tiled_check_positions(generator, batch, shape, dtype):
    """Bin-space positions of a narrow Gaussian beam, so that the edge tiles
    hold few or no particles and the centre tiles are crowded, with a share
    spilling past every edge and parked (-2), NaN, +-inf and -1e30
    particles."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    size = (batch, NUM_PARTICLES, 3)
    normalized = n / 2 + torch.randn(size, generator=generator, dtype=dtype, device="cuda") * n / 10
    spill = torch.rand(size, generator=generator, dtype=dtype, device="cuda") * (n + 2.0) - 1.5
    normalized[:, ::13] = spill[:, ::13]
    normalized[:, ::97] = -2.0
    normalized[:, 1::1009, 0] = float("nan")
    normalized[:, 2::1009, 1] = float("inf")
    normalized[:, 3::1009, 2] = -1e30
    normalized[:, 4::1009, 0] = float("inf")
    normalized[:, 5::1009, 0] = -float("inf")
    return normalized


def _bits(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers, so that NaN compares equal to itself."""
    kinds = {torch.float32: torch.int32, torch.float64: torch.int64}
    return tensor.view(kinds[tensor.dtype]) if tensor.dtype in kinds else tensor


def _check_plan(cic_tiled, normalized, shape) -> bool:
    """The card's counting-sort plan against ``tile_plan`` (``torch.sort``)
    on the card: every field equal, bit for bit."""
    card = cic_tiled.plan_tiles(normalized, shape)
    plain = cic_tiled.tile_plan(normalized, shape)
    torch.cuda.synchronize()
    for field in ("offsets", "perm", "rank", "sorted_tile", "sorted_positions"):
        check(
            torch.equal(_bits(getattr(card, field)), _bits(getattr(plain, field))),
            f"{shape}: the card's plan differs from tile_plan in {field}",
        )
    check((card.rows_per_tile, card.num_tiles) == (plain.rows_per_tile, plain.num_tiles),
          f"{shape}: plan tiling differs")
    return True


def phase_kernels_tiled(cic_kernels, cic_tiled) -> dict:
    """The x-tiled kernels against their plain versions and against the
    untiled kernels on the card, at all 8 orders, B in {1, 4}, float32 and
    float64, on grids past the untiled bound; then timed at the 128^3
    path's shape. Returns the numbers for the ``kernels`` line."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"deposit": 0.0, "gather": 0.0, "deposit_vs_untiled": 0.0, "gather_vs_untiled": 0.0}
    # Plus the grid with the largest window row: ny = 1, nt = 512, in f64.
    for batch, shape, dtype in [
        *itertools.product((1, 4), TILED_SHAPES, (torch.float32, torch.float64)),
        (1, (1024, 1, 512), torch.float64),
        # A window past a block's shared memory (2 MB): no windows at all.
        (1, (8, 256, 512), torch.float64),
    ]:
        check(cic_kernels.uses_tiled(shape), f"{shape} is not dispatched to the tiled kernels")
        normalized = _tiled_check_positions(generator, batch, shape, dtype)
        plan_equal = _check_plan(cic_tiled, normalized, shape)
        rows = torch.randn(
            (batch, len(ALL_ORDERS), 1, NUM_PARTICLES), generator=generator,
            dtype=dtype, device="cuda",
        )
        got = cic_tiled.deposit_multi_tiled_3d(normalized, rows, shape, ALL_ORDERS)
        want = cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, ALL_ORDERS)
        untiled = cic_kernels._deposit_untiled(normalized, rows, shape, ALL_ORDERS)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "tiled deposit produced non-finite values")
        deposit_error = relative_error(got, want)[1]
        deposit_untiled = relative_error(got, untiled)[1]
        del got, want, untiled

        grids = torch.randn((batch, 3, *shape), generator=generator, dtype=dtype, device="cuda")
        got = cic_tiled.gather_multi_tiled_3d(grids, normalized, ALL_ORDERS)
        want = cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, ALL_ORDERS)
        untiled = cic_kernels._gather_untiled(grids, normalized, ALL_ORDERS)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "tiled gather produced non-finite values")
        gather_error = max(relative_error(g, w)[1] for g, w in zip(got, want))
        gather_untiled = max(relative_error(g, u)[1] for g, u in zip(got, untiled))
        gather_error = max(gather_error, _path_sets_error(
            cic_tiled.gather_multi_tiled_3d, cic_tiled.gather_multi_tiled_3d_reference, grids,
            normalized,
        ))
        emit(
            "kernel_tiled_check",
            batch=batch, grid=list(shape), particles=NUM_PARTICLES, orders=len(ALL_ORDERS),
            dtype=str(dtype).removeprefix("torch."),
            rows_per_tile=cic_tiled.rows_per_tile(shape), plan_equals_tile_plan=plan_equal,
            deposit_route=_deposit_route(cic_kernels, cic_tiled, shape, dtype, batch, 1),
            deposit_rel_err=deposit_error, deposit_rel_diff_untiled=deposit_untiled,
            gather_components=3, gather_rel_err=gather_error,
            gather_rel_diff_untiled=gather_untiled,
        )
        check(deposit_error <= DEPOSIT_TOLERANCE, f"tiled deposit error {deposit_error}")
        check(deposit_untiled <= DEPOSIT_TOLERANCE, f"tiled vs untiled deposit {deposit_untiled}")
        check(gather_error <= GATHER_TOLERANCE, f"tiled gather error {gather_error}")
        check(gather_untiled <= GATHER_TOLERANCE, f"tiled vs untiled gather {gather_untiled}")
        for key, value in (("deposit", deposit_error), ("gather", gather_error),
                           ("deposit_vs_untiled", deposit_untiled),
                           ("gather_vs_untiled", gather_untiled)):
            worst[key] = max(worst[key], value)
        del normalized, rows, grids, got, want, untiled

    # The plan's other layouts: past 65536 counts the scan launch runs
    # (256^3, 1M particles), past 3040 tiles each block is one warp counting
    # in global memory ((20000, 128, 4), 100k particles).
    for shape, count in (((256, 256, 256), NUM_PARTICLES), ((20000, 128, 4), 100_000)):
        normalized = _tiled_check_positions(generator, 2, shape, torch.float32)[:, :count]
        emit("plan_check", grid=list(shape), batch=2, particles=count,
             tiles=cic_tiled.tile_plan(normalized, shape).num_tiles,
             plan_equals_tile_plan=_check_plan(cic_tiled, normalized.contiguous(), shape))
        del normalized

    # The 128^3 path's shape: one instance, 1M particles of a Gaussian beam
    # on a grid of +-3 sigma, the value order; the deposit carries the
    # charge (C=1), the gather the three force components (C=3).
    shape = (128, 128, 128)
    f32 = torch.float32
    cells = shape[0] * shape[1] * shape[2]
    value = cic_kernels.VALUE
    positions = _beam_positions(generator, shape, -0.5, f32)
    charges = torch.rand((1, 1, 1, NUM_PARTICLES), generator=generator, dtype=f32, device="cuda")
    got = cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value)
    want = cic_tiled.deposit_multi_tiled_3d_reference(positions, charges, shape, value)
    deposit_abs, deposit_rel = relative_error(got, want)
    check(deposit_rel <= DEPOSIT_TOLERANCE, f"tiled deposit error {deposit_rel} at the main shape")
    deposit = {
        "ms": graph_ms(lambda: cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value)),
        "eager_ms": time_ms(
            lambda: cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value),
            per_event=10,
        ),
        "plain_ms": time_ms(
            lambda: cic_tiled.deposit_multi_tiled_3d_reference(positions, charges, shape, value),
            per_event=10,
        ),
        "untiled_ms": graph_ms(
            lambda: cic_kernels._deposit_untiled(positions, charges, shape, value)
        ),
        "plan_ms": graph_ms(lambda: cic_tiled.plan_tiles(positions, shape)),
        "max_abs_err": deposit_abs, "rel_err": deposit_rel,
        "route": _deposit_route(cic_kernels, cic_tiled, shape, f32, 1, 1),
    }
    positions_plan = cic_tiled.plan_tiles(positions, shape)
    deposit["kernel_ms"] = graph_ms(
        lambda: cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value,
                                                 plan=positions_plan)
    )
    # Inputs read once (positions, charges), the grid written once.
    deposit_bound = bound(NUM_PARTICLES * (3 + 1) * 4 + cells * 4, NUM_PARTICLES * 8 * 5)
    deposit_c3 = _deposit_c3(cic_tiled.deposit_multi_tiled_3d,
                             cic_tiled.deposit_multi_tiled_3d_reference, generator, positions,
                             shape)
    deposit_c3["kernel_ms"] = _deposit_c3(
        cic_tiled.deposit_multi_tiled_3d, cic_tiled.deposit_multi_tiled_3d_reference, generator,
        positions, shape, plan=positions_plan,
    )["ms"]
    deposit_c3["untiled_ms"] = _deposit_c3(
        cic_kernels._deposit_untiled, cic_tiled.deposit_multi_tiled_3d_reference, generator,
        positions, shape,
    )["ms"]
    deposit_c3["route"] = _deposit_route(cic_kernels, cic_tiled, shape, f32, 1, 3)

    nodes = _beam_positions(generator, shape, 0.0, f32)
    grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
    (got,) = cic_tiled.gather_multi_tiled_3d(grids, nodes, value)
    (want,) = cic_tiled.gather_multi_tiled_3d_reference(grids, nodes, value)
    gather_abs, gather_rel = relative_error(got, want)
    check(gather_rel <= GATHER_TOLERANCE, f"tiled gather error {gather_rel} at the main shape")
    scale = torch.tensor([shape[2] - 1, shape[1] - 1, shape[0] - 1], dtype=f32, device="cuda")
    sample_grid = (nodes.flip(-1) / scale * 2 - 1).view(1, 1, 1, NUM_PARTICLES, 3)

    def library_gather():
        return torch.nn.functional.grid_sample(
            grids, sample_grid, mode="bilinear", padding_mode="zeros", align_corners=True
        )

    _check_plan(cic_tiled, nodes, shape)
    plan = cic_tiled.plan_tiles(nodes, shape)
    keys = torch.nan_to_num(
        torch.floor(torch.floor(nodes[..., 0]) / plan.rows_per_tile).clamp(0, plan.num_tiles - 1)
    ).to(torch.int32)
    gather = {
        "ms": graph_ms(lambda: cic_tiled.gather_multi_tiled_3d(grids, nodes, value)),
        "eager_ms": time_ms(
            lambda: cic_tiled.gather_multi_tiled_3d(grids, nodes, value), per_event=10
        ),
        "kernel_ms": graph_ms(
            lambda: cic_tiled.gather_multi_tiled_3d(grids, nodes, value, plan=plan)
        ),
        "plain_ms": time_ms(
            lambda: cic_tiled.gather_multi_tiled_3d_reference(grids, nodes, value), per_event=10
        ),
        "untiled_ms": graph_ms(lambda: cic_kernels._gather_untiled(grids, nodes, value)),
        "library_ms": graph_ms(library_gather),
        "library_eager_ms": time_ms(library_gather, per_event=10),
        "grid_sample_rel_diff": relative_error(library_gather().view(1, 3, NUM_PARTICLES), want)[1],
        "plan_ms": graph_ms(lambda: cic_tiled.plan_tiles(nodes, shape)),
        "plan_eager_ms": time_ms(lambda: cic_tiled.plan_tiles(nodes, shape), per_event=10),
        "plan_plain_ms": time_ms(lambda: cic_tiled.tile_plan(nodes, shape), per_event=10),
        # The stable sort of the keys alone, which the earlier plan ran.
        "plan_torch_sort_ms": graph_ms(lambda: torch.sort(keys, dim=1, stable=True)),
        "max_abs_err": gather_abs, "rel_err": gather_rel,
    }
    # The plan must read the positions and write the permutation (8 B),
    # the tiles (4 B) and the sorted positions once a particle.
    plan_bound = bound(NUM_PARTICLES * (3 * 4 + 8 + 4 + 3 * 4), NUM_PARTICLES * 4)
    plan_abs = (plan.sorted_positions - cic_tiled.tile_plan(nodes, shape).sorted_positions).abs()
    # Where the wrappers' time goes, the plans' sorts against the kernels:
    # one profile over one call of each.
    profile_path(
        "tiled_wrappers_main_shape",
        lambda: (cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value),
                 cic_tiled.gather_multi_tiled_3d(grids, nodes, value)),
        deposit["ms"] + gather["ms"],
    )
    # Grids and positions read once, the three outputs written once.
    gather_bound = bound(
        cells * 3 * 4 + NUM_PARTICLES * 3 * 4 + NUM_PARTICLES * 3 * 4, NUM_PARTICLES * 3 * 8 * 4
    )
    emit(
        "kernel_tiled_main_shape",
        grid=list(shape), particles=NUM_PARTICLES, rows_per_tile=cic_tiled.rows_per_tile(shape),
        deposit={**deposit, "bound_ms": deposit_bound[0]},
        deposit_c3=deposit_c3,
        gather={**gather, "bound_ms": gather_bound[0]},
        plan={"ms": gather["plan_ms"], "plain_ms": gather["plan_plain_ms"],
              "torch_sort_ms": gather["plan_torch_sort_ms"], "bound_ms": plan_bound[0]},
        worst_rel_err_all_orders=worst,
    )
    return {
        "plan": dict(
            ms=gather["plan_ms"], eager_ms=gather["plan_eager_ms"],
            plain_ms=gather["plan_plain_ms"], bound_ms=plan_bound[0],
            bound_by=plan_bound[1], library_ms=None,
            max_abs_err=float(plan_abs.nan_to_num(0.0).max()),
        ),
        "deposit": dict(
            ms=deposit["ms"], eager_ms=deposit["eager_ms"], plain_ms=deposit["plain_ms"],
            bound_ms=deposit_bound[0], bound_by=deposit_bound[1], library_ms=None,
            max_abs_err=deposit_abs, kernel_ms=deposit["kernel_ms"],
            c3_ms=deposit_c3["ms"], c3_kernel_ms=deposit_c3["kernel_ms"],
            c3_bound_ms=deposit_c3["bound_ms"],
        ),
        "gather": dict(
            ms=gather["ms"], eager_ms=gather["eager_ms"], plain_ms=gather["plain_ms"],
            bound_ms=gather_bound[0], bound_by=gather_bound[1],
            library_ms=gather["library_ms"], max_abs_err=gather_abs,
        ),
    }


def phase_gather_order_sets(cic_kernels, cic_tiled) -> dict:
    """The gathers at the order sets and component counts of the paths, on
    the 32^3 and 64^3 grids (untiled kernels) and the 128^3 grid (tiled
    kernels, with and without its plan), 1M particles of a Gaussian beam in
    float32: against their plain versions, timed, with their bounds; and
    the staged kernels against the L1/L2 ones (:func:`_unaligned`). Returns
    the numbers by grid and set."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 3)
    f32 = torch.float32
    results = {}
    for side in (32, 64, 128):
        shape = (side, side, side)
        cells = side**3
        tiled = cic_kernels.uses_tiled(shape)
        nodes = _beam_positions(generator, shape, 0.0, f32)
        grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
        plan = cic_tiled.plan_tiles(nodes, shape) if tiled else None
        for label, orders, components in PATH_ORDER_SETS:
            values = grids[:, :components].contiguous()
            if tiled:
                got = cic_tiled.gather_multi_tiled_3d(values, nodes, orders)
                want = cic_tiled.gather_multi_tiled_3d_reference(values, nodes, orders)
            else:
                got = cic_kernels.gather_multi_3d(values, nodes, orders)
                want = cic_kernels.gather_multi_3d_reference(values, nodes, orders)
            errors = [relative_error(g, w) for g, w in zip(got, want)]
            rel = max(e[1] for e in errors)
            check(rel <= GATHER_TOLERANCE, f"{shape} {label}: gather error {rel}")
            wrapper = cic_tiled.gather_multi_tiled_3d if tiled else cic_kernels.gather_multi_3d
            plain = (cic_tiled.gather_multi_tiled_3d_reference if tiled
                     else cic_kernels.gather_multi_3d_reference)
            entry = {
                "ms": graph_ms(lambda: wrapper(values, nodes, orders)),
                "eager_ms": time_ms(lambda: wrapper(values, nodes, orders), per_event=10),
                "plain_ms": time_ms(lambda: plain(values, nodes, orders), per_event=10),
                "max_abs_err": max(e[0] for e in errors), "rel_err": rel,
            }
            # The grid as the path gives it (staged in shared memory where
            # the grid or the tile's window fits) and unaligned (read through
            # L1 and L2), in turns; kernels alone, with the plan made before.
            unaligned = _unaligned(values)
            for key in ("as_given", "l1_l2", "l1_l2", "as_given"):
                given = values if key == "as_given" else unaligned
                got = wrapper(given, nodes, orders, **({"plan": plan} if tiled else {}))
                rel = max(relative_error(g, w)[1] for g, w in zip(got, want))
                check(rel <= GATHER_TOLERANCE, f"{shape} {label} {key}: gather error {rel}")
                ms = graph_ms(
                    lambda: wrapper(given, nodes, orders, **({"plan": plan} if tiled else {}))
                )
                entry[f"{key}_kernel_ms"] = min(ms, entry.get(f"{key}_kernel_ms", ms))
            if tiled:
                entry["kernel_ms"] = graph_ms(
                    lambda: cic_tiled.gather_multi_tiled_3d(values, nodes, orders, plan=plan)
                )
            # Grid and positions read once, the O * C outputs written once.
            size, count = 4, len(orders)
            entry["bound_ms"] = bound(
                size * (components * cells + NUM_PARTICLES * (3 + count * components)),
                NUM_PARTICLES * components * 8 * 4 * count,
            )[0]
            results[f"{side}_{label}"] = entry
            del got, want
        emit("gather_order_sets", grid=list(shape), particles=NUM_PARTICLES, dtype="float32",
             kernel="gather_multi_tiled_3d" if tiled else "gather_multi_3d",
             sets={label: results[f"{side}_{label}"] for label, _, _ in PATH_ORDER_SETS})
    return results


def phase_autograd_kernels(cic_kernels, wrappers) -> None:
    """gradcheck and gradgradcheck of the autograd closure in float64 on
    the card, on an untiled and a tiled grid (the backward of a backward
    stays on the kernels). Atomic sums may differ in the last bits between
    two backward passes, so ``nondet_tol`` allows 1e-12."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 2)
    orders = ((0, 0, 0), (1, 0, 0), (0, 1, 1))
    results = []
    for shape in ((8, 7, 6), (1025, 4, 2)):
        n = torch.tensor(shape, dtype=torch.float64, device="cuda")
        positions = torch.rand(
            (1, 24, 3), generator=generator, dtype=torch.float64, device="cuda"
        ) * (n - 0.6) - 0.8
        # Off the integers, where the weights have kinks.
        near = (positions - positions.round()).abs() < 0.05
        normalized = (positions + 0.1 * near).requires_grad_()
        grids = torch.randn(
            (1, 2, *shape), generator=generator, dtype=torch.float64, device="cuda"
        ).requires_grad_()
        rows = torch.randn(
            (1, len(orders), 2, 24), generator=generator, dtype=torch.float64, device="cuda"
        ).requires_grad_()
        options = {"fast_mode": True, "atol": 1e-7, "rtol": 1e-6, "nondet_tol": 1e-12}

        def gather(g, p):
            return cic_kernels.differentiable_gather(g, p, orders)

        def deposit(p, r):
            return cic_kernels.differentiable_deposit(p, r, shape, orders)

        _reset_launches(wrappers)
        check(torch.autograd.gradcheck(gather, (grids, normalized), **options), "gradcheck gather")
        check(torch.autograd.gradgradcheck(gather, (grids, normalized), **options),
              "gradgradcheck gather")
        check(torch.autograd.gradcheck(deposit, (normalized, rows), **options), "gradcheck deposit")
        check(torch.autograd.gradgradcheck(deposit, (normalized, rows), **options),
              "gradgradcheck deposit")
        launches = _launches(wrappers)
        tiled = cic_kernels.uses_tiled(shape)
        used = [name for name, count in launches.items() if count > 0]
        check(
            sorted(used) == sorted(name for name in wrappers if (name in TILED_WRAPPERS) == tiled),
            f"{shape}: the checks launched {launches}",
        )
        results.append({"grid": list(shape), "tiled": tiled, "launches": launches})
    emit("autograd_kernels", dtype="float64", orders=[list(o) for o in orders],
         checks=["gradcheck", "gradgradcheck"], passed=True, grids=results)


def _sc_value_and_grad(segment, beam, length_value):
    """sum(px^2) after the segment and its derivative with respect to the
    first drift's length (``space_charge_grad`` of ``scripts/bench_all.py``)."""
    length = torch.tensor(
        length_value, dtype=beam.particles.dtype, device=beam.particles.device,
        requires_grad=True,
    )
    segment.elements[0].length = length
    value = torch.sum(torch.square(segment.track(beam).px))
    (grad,) = torch.autograd.grad(value, length)
    return value.detach(), grad


def phase_sc_grad(ctt, wrappers, grid_shape, uses_tiled: bool) -> tuple[dict, dict]:
    """value_and_grad of the space-charge segment at 1M particles on the
    card (float32): launches of the forward and of the backward (tile plans
    included, none of them by ``torch.sort``), the gradient against the
    port's float64 CPU run and against a float64 central difference on the
    card, the CUDA-event time and a profile. Returns the launches and the
    profile's CIC kernel times."""
    from cheetah_tpu_torch.ops import cic_tiled

    label = f"sc_grad_{grid_shape[0]}"
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
    segment = _sc_segment(ctt, torch.float32, "cuda", grid_shape)

    length = torch.tensor(0.1, device="cuda", requires_grad=True)
    segment.elements[0].length = length
    sorts_before = cic_tiled.tile_plan.calls
    _reset_launches(wrappers)
    value = torch.sum(torch.square(segment.track(beam).px))
    forward = _launches(wrappers)
    _reset_launches(wrappers)
    (grad,) = torch.autograd.grad(value, length)
    backward = _launches(wrappers)
    check(cic_tiled.tile_plan.calls == sorts_before, f"{label}: a plan went through torch.sort")
    check(bool(torch.isfinite(grad)) and grad.item() != 0, f"{label}: gradient {grad.item()}")
    # Per kick: forward, one deposit (charge) and one gather (forces);
    # backward, the gather's transpose (one deposit of the force
    # gradients), its raised-order gather for the positions, and the
    # deposit's raised-order gather for the positions (the charges need no
    # gradient). Only the pair that the grid is dispatched to may launch.
    # On the tiled pair each kick's deposit and gather make one plan each,
    # in forward, which every launch of their backward reuses.
    kind = "tiled_3d" if uses_tiled else "3d"
    expected_forward = {name: 0 for name in wrappers}
    expected_backward = dict(expected_forward)
    expected_forward.update({f"deposit_multi_{kind}": 2, f"gather_multi_{kind}": 2})
    expected_backward.update({f"deposit_multi_{kind}": 2, f"gather_multi_{kind}": 4})
    if uses_tiled:
        expected_forward["plan_tiles"] = 4
    check(forward == expected_forward and backward == expected_backward,
          f"{label}: launches forward {forward}, backward {backward}")

    start = time.perf_counter()
    value_cpu, grad_cpu = _sc_value_and_grad(
        _sc_segment(ctt, torch.float64, "cpu", grid_shape), beam.to("cpu", torch.float64), 0.1
    )
    cpu_seconds = time.perf_counter() - start
    f32_error = abs(grad.item() - grad_cpu.item()) / abs(grad_cpu.item())

    segment64 = _sc_segment(ctt, torch.float64, "cuda", grid_shape)
    beam64 = beam.to(dtype=torch.float64)
    _, grad64 = _sc_value_and_grad(segment64, beam64, 0.1)
    f64_error = abs(grad64.item() - grad_cpu.item()) / abs(grad_cpu.item())

    def loss64(length_value):
        segment64.elements[0].length = torch.tensor(
            length_value, dtype=torch.float64, device="cuda"
        )
        return torch.sum(torch.square(segment64.track(beam64).px)).item()

    with torch.no_grad():
        fd = (loss64(0.1 + SC_GRAD_FD_STEP) - loss64(0.1 - SC_GRAD_FD_STEP)) / (2 * SC_GRAD_FD_STEP)
    fd_error = abs(fd - grad64.item()) / abs(grad64.item())

    ms = time_ms(lambda: _sc_value_and_grad(segment, beam, 0.1), runs=10, warmup=2)
    families = profile_path(label, lambda: _sc_value_and_grad(segment, beam, 0.1), ms)
    emit(
        label,
        particles=NUM_PARTICLES, grid=list(grid_shape), dtype="float32", ms=ms,
        value=value.item(), grad=grad.item(),
        launches={"forward": forward, "backward": backward},
        grad_cpu_f64=grad_cpu.item(), grad_rel_err_vs_cpu_f64=f32_error,
        grad_card_f64=grad64.item(), card_f64_rel_err_vs_cpu_f64=f64_error,
        finite_difference_f64=fd, fd_step=SC_GRAD_FD_STEP, fd_rel_diff=fd_error,
        cpu_f64_seconds=cpu_seconds,
    )
    check(f32_error <= SC_GRAD_F32_RTOL[grid_shape], f"{label}: f32 gradient off by {f32_error}")
    check(f64_error <= SC_GRAD_F64_RTOL, f"{label}: f64 gradient off by {f64_error}")
    check(fd_error <= SC_GRAD_FD_RTOL, f"{label}: finite difference off by {fd_error}")
    return {name: forward[name] + backward[name] for name in wrappers}, families


def phase_env_step_grad(ctt, wrappers) -> None:
    """d sum(sigma_x) / d k1 of the env step on the card (float32), one
    instance at exactly k1 = 0, against the port's float64 CPU gradient."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances, num_particles = 4096, 10_000
    zero = num_instances // 2
    segment = ares_ea_subcell(torch.float32)
    k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    k1[zero] = 0.0
    k1.requires_grad_()
    segment.AREAMQZM1.k1 = k1
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, num_particles, "cuda", generator)

    def value_and_grad():
        value = segment.track(beam).sigma_x.sum()
        return value.detach(), torch.autograd.grad(value, k1)[0]

    _reset_launches(wrappers)
    _, grad = value_and_grad()
    launches = _launches(wrappers)
    check(tuple(grad.shape) == (num_instances,), f"k1 gradient shape {tuple(grad.shape)}")
    check(bool(torch.isfinite(grad).all()), "non-finite k1 gradient")

    picks = sorted({*torch.linspace(0, num_instances - 1, 8).round().long().tolist(), zero})
    reference = ares_ea_subcell(torch.float64, device="cpu")
    k1_cpu = k1.detach()[picks].cpu().double().requires_grad_()
    reference.AREAMQZM1.k1 = k1_cpu
    (expected,) = torch.autograd.grad(
        reference.track(beam.to("cpu", torch.float64)).sigma_x.sum(), k1_cpu
    )
    actual = grad[picks].cpu().double()
    error = ((actual - expected).abs().max() / expected.abs().max()).item()
    ms = time_ms(value_and_grad, runs=10)
    profile_path("env_step_grad", value_and_grad, ms)
    emit(
        "env_step_grad",
        instances=num_instances, particles=num_particles, ms=ms,
        grad_at_k1_zero=grad[zero].item(),
        grad_at_k1_zero_cpu_f64=expected[picks.index(zero)].item(),
        grad_err_vs_cpu_f64=error, kernel_launches=launches,
    )
    check(error <= ENV_GRAD_TOLERANCE, f"env step k1 gradient off by {error}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    wrappers = _wrappers(cic_kernels, cic_tiled)
    smi = phase_environment()
    phase_build([cic_kernels.LIBRARY, cic_tiled.LIBRARY])
    numbers = phase_kernels(cic_kernels)
    tiled_numbers = phase_kernels_tiled(cic_kernels, cic_tiled)
    emit("deposit_crowded", particles=NUM_PARTICLES, cells=8,
         cases=_crowded_deposit_errors(cic_kernels, cic_tiled,
                                       torch.Generator(device="cuda").manual_seed(SEED + 5)))
    phase_gather_order_sets(cic_kernels, cic_tiled)
    phase_autograd_kernels(cic_kernels, wrappers)
    phase_env_step(ctt, wrappers)
    segment_launches = phase_space_charge(ctt, wrappers)
    phase_env_step_grad(ctt, wrappers)
    grad_launches = {
        grid[0]: phase_sc_grad(ctt, wrappers, grid, cic_kernels.uses_tiled(grid))[0]
        for grid in ((32, 32, 32), (128, 128, 128))
    }

    def entry(name, source, replaces, measured, **extra):
        by_path = {"space_charge_segment": segment_launches[name],
                   "sc_grad_32": grad_launches[32][name], "sc_grad_128": grad_launches[128][name]}
        launches = by_path["sc_grad_32"] + by_path["sc_grad_128"]
        check(launches > 0, f"{name} was not launched on its path")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path, **measured, **extra,
        }

    untiled, tiled = "cheetah_tpu_torch/csrc/cic.cu", "cheetah_tpu_torch/csrc/cic_tiled.cu"
    kernels = [
        entry("deposit_multi_3d", untiled, "cheetah_tpu/ops/pallas_cic.py:316",
              numbers["deposit"]),
        entry("gather_multi_3d", untiled, "cheetah_tpu/ops/pallas_cic.py:238", numbers["gather"]),
        entry("deposit_multi_tiled_3d", tiled, "cheetah_tpu/ops/pallas_cic_tiled.py:248",
              tiled_numbers["deposit"]),
        entry("gather_multi_tiled_3d", tiled, "cheetah_tpu/ops/pallas_cic_tiled.py:393",
              tiled_numbers["gather"]),
        entry("plan_tiles", tiled, "cheetah_tpu/ops/pallas_cic_tiled.py:108",
              tiled_numbers["plan"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
