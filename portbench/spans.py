"""The program's spans in a traced window (:class:`portbench.trace.Trace`).

The port marks its layers with ``record_function`` ranges whose names
start with ``ctt.`` (``cheetah_tpu_torch.utils.profiling``); they are among
the window's host operations, on the clock of the device's operations. A
program without them gives no interval, and the readers that need one read
nothing.

A :class:`~portbench.trace.Trace` keeps each event's name and interval, not
its thread or correlation id; so what lies in a span is found by time, on
the host: the runtime calls that launch kernels, the host's reads of
device values, the card's idle time. The autograd engine's device thread
runs outside every forward span, so a backward's launches lie in none.
"""

from __future__ import annotations

#: The first characters of every span of the program.
SPAN_PREFIX = "ctt."
#: The host's runtime calls that launch a kernel.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
#: The operator under every read of a device value on the host (``.item()``,
#: ``bool(...)``, ``int(...)``): each one waits for the stream to drain.
SCALAR_READ = "aten::_local_scalar_dense"


def merged(intervals) -> list[tuple[int, int]]:
    """``intervals`` as sorted disjoint intervals."""
    out: list[list[int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def intervals(trace, name: str) -> list[tuple[int, int]]:
    """Where the host is inside the span ``name`` in the window, merged."""
    start, end = trace.window_ns
    return merged((max(lo, start), min(hi, end)) for op, lo, hi in trace.host_ops
                  if op == name and hi > start and lo < end)


def launches(trace) -> list[int]:
    """The start of each kernel launch on the host in the window."""
    start, end = trace.window_ns
    return sorted(lo for op, lo, _ in trace.host_ops if op in LAUNCH_CALLS and start <= lo < end)


def count_inside(points: list[int], spans: list[tuple[int, int]]) -> int:
    """How many of the sorted ``points`` lie in the sorted disjoint ``spans``."""
    import bisect

    return sum(bisect.bisect_left(points, hi) - bisect.bisect_left(points, lo)
               for lo, hi in spans)


def idle(trace) -> list[tuple[int, int]]:
    """The gaps of the window in which no operation runs on the card."""
    gaps, cursor = [], trace.window_ns[0]
    for lo, hi in trace.busy_intervals():
        if lo > cursor:
            gaps.append((cursor, lo))
        cursor = max(cursor, hi)
    if cursor < trace.window_ns[1]:
        gaps.append((cursor, trace.window_ns[1]))
    return gaps


def overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """The time two lists of sorted disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def by_span(trace) -> dict[str, dict[str, float]]:
    """Each span's kernel launches, host time and card's idle time a step,
    counted where the host is inside any span of the name (so a span's
    numbers hold those of the spans nested in it)."""
    names = sorted({op for op, _, _ in trace.host_ops if op.startswith(SPAN_PREFIX)})
    points, gaps = launches(trace), idle(trace)
    table = {}
    for name in names:
        spans = intervals(trace, name)
        table[name] = {
            "launches": count_inside(points, spans) / trace.steps,
            "host_ms": sum(hi - lo for lo, hi in spans) / 1e6 / trace.steps,
            "idle_ms": overlap_ns(gaps, spans) / 1e6 / trace.steps,
        }
    return table
