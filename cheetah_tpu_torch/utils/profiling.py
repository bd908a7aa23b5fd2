"""Profiling helpers (counterpart of ``cheetah_tpu/utils/profiling.py``).

A trace on ``torch.profiler``; timers that use CUDA events when the work
runs on a card and the host's clock when it runs on the CPU; and the
FLOPs and bytes of one call (the counterpart of XLA's cost analysis).
Each function keeps the JAX function's return contract.

The port's own spans and counters live here too. A span (:func:`span`)
marks a layer of the tracking code; a counter (:func:`count`) counts an
event that the device's trace does not show. Spans are off unless one of
two sinks is on:

* a ``torch.profiler`` profile, e.g. ``with trace(log_dir) as profile:``:
  each span is a ``record_function`` range in the same trace, on the same
  clock, as the card's kernels. :func:`span_table` then gives each span's
  device time, kernel launches and device idle time, a kernel launched by
  the autograd engine counting under ``<span>.backward`` of the span that
  ran the forward operation (by the operation's ``sequence_nr``);
  :func:`profiled_spans` gives the spans as a tree.
* ``with recording() as spans:``: each span's times on the host's
  ``time.perf_counter_ns``, without the profiler and its cost to the host
  (``spans.spans``, ``spans.summary()``).

With neither on, a span tests whether the compiler traces the code and two
module flags, returns a shared no-op context and calls no torch operator;
under ``torch.compile`` and ``torch.export`` a span is always the no-op.
Counters are always on: :func:`counters` returns a snapshot, and the
difference of two snapshots counts what ran between them.

The spans, each around what the port runs for it:

- ``ctt.env.step``: ``BatchedLatticeEnv.step`` (nested in ``grad_step``'s
  forward); ``ctt.env.grad_step``: ``BatchedLatticeEnv.grad_step``;
  ``ctt.env.readout``: the objective, or the default reward, of a step.
- ``ctt.segment.track``: ``Segment._track``, ``track_moments``,
  ``track_with_readings`` and ``track_checkpointed`` (nested segments
  nest); ``ctt.plan``: ``Segment._plan``, the fused runs and brackets.
- ``ctt.maps``: building a transfer map (an element's or a fused run's 7x7
  map, a T-tensor, a second-order bracket's folded map);
  ``ctt.transport``: applying it (the particles' matmul, the covariance
  congruence, the quadratic map).
- ``ctt.sc.kick``: ``SpaceChargeKick._track``, with the children
  ``ctt.sc.grid`` (sigmas, grid geometry, normalised positions),
  ``ctt.sc.deposit`` (the charge deposit with its tile plan, density and
  padding), ``ctt.sc.green_function`` (the integrated Green function),
  ``ctt.sc.fft`` (the two forward transforms, their product and the
  inverse), ``ctt.sc.fields`` (the central differences) and
  ``ctt.sc.gather`` (the gather and the kick's ``index_add``).

The counters: ``host_reads`` (each read of a tensor's value on the host in
the elements' and segments' code, a device sync on the card) and the CIC
operators' kernel launches by wrapper (``deposit_multi_3d``,
``gather_multi_3d``, ``deposit_multi_tiled_3d``, ``gather_multi_tiled_3d``,
``plan_tiles``).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: The first characters of every span's name.
SPAN_PREFIX = "ctt."

_COUNTS: dict[str, int] = {}
#: The open :class:`Recording`, or ``None``.
_recording: "Recording | None" = None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    return dict(_COUNTS)


#: The context of a span with no sink on.
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """A span with a sink on: a ``record_function`` range while a profile
    runs, an entry of the open :class:`Recording` while one is open."""

    __slots__ = ("name", "_range", "_recording", "_index")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._recording = _recording
        if self._recording is not None:
            self._index = self._recording._enter(self.name)

    def __exit__(self, *exc) -> bool:
        if self._recording is not None:
            self._recording._exit(self._index)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context that marks ``name`` (a name of the module's table, which
    starts with :data:`SPAN_PREFIX`) around the work of a layer, for the
    sinks that are on; the shared no-op where none is, or where
    ``torch.compile`` or ``torch.export`` traces the code."""
    # The compiler's test first, so that a compiled caller holds no guard
    # on the sinks' flags and is not compiled again when a sink turns on.
    # The compiler traces a context made inside the code it compiles.
    if torch.compiler.is_compiling():
        return contextlib.nullcontext()
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


class Recording:
    """The spans of a :func:`recording`, on the host's clock.

    ``spans`` is filled when the recording ends: one ``(name, parent,
    start_ns, end_ns)`` a span, in the order they were entered, ``parent``
    the index of the span it is nested in on its thread or ``-1``.
    """

    def __init__(self) -> None:
        self.spans: list[tuple[str, int, int, int]] = []
        # Parallel lists of plain values while the recording runs: a list
        # of lists would keep the garbage collector busy at every span.
        self._names: list[str] = []
        self._parents: list[int] = []
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._threads = threading.local()

    def _stack(self) -> list[int]:
        stack = getattr(self._threads, "stack", None)
        if stack is None:
            stack = self._threads.stack = []
        return stack

    def _enter(self, name: str) -> int:
        stack = self._stack()
        index = len(self._names)
        self._names.append(name)
        self._parents.append(stack[-1] if stack else -1)
        self._ends.append(-1)
        stack.append(index)
        self._starts.append(time.perf_counter_ns())
        return index

    def _exit(self, index: int) -> None:
        self._ends[index] = time.perf_counter_ns()
        self._stack().pop()

    def _close(self) -> None:
        self.spans = list(zip(self._names, self._parents, self._starts, self._ends))

    def summary(self) -> dict[str, dict[str, float]]:
        """Each name's ``count`` and its host time in ``ms``, a span nested
        in one of its own name counted once, in the outer one."""
        names = [entry[0] for entry in self.spans]
        table: dict[str, dict[str, float]] = {}
        for name, parent, start, end in self.spans:
            row = table.setdefault(name, {"count": 0, "ms": 0.0})
            row["count"] += 1
            while parent >= 0 and names[parent] != name:
                parent = self.spans[parent][1]
            if parent < 0:
                row["ms"] += (end - start) / 1e6
        return table


@contextlib.contextmanager
def recording():
    """Turn the spans' host-clock sink on for the ``with`` block; yields the
    :class:`Recording`, whose ``spans`` hold the block's spans when it ends.
    Recordings do not nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("A recording is open already.")
    spans = Recording()
    _recording = spans
    try:
        yield spans
    finally:
        _recording = None
        spans._close()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the host and, where a card is present, of the
    device, written to ``log_dir`` for TensorBoard or Perfetto. Yields the
    ``torch.profiler.profile``, which :func:`span_table` and
    :func:`profiled_spans` read once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ) as profile:
        yield profile


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of ``tree``; a beam's tensors are its ``__dict__``'s."""
    leaves = tree_leaves(tree)
    found = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            found.append(leaf)
        elif hasattr(leaf, "__dict__"):
            found += [value for value in vars(leaf).values() if isinstance(value, torch.Tensor)]
    return found


def _on_card(args: tuple, out: Any) -> bool:
    return any(tensor.is_cuda for tensor in _tensors(args) + _tensors(out))


def _fetch(out: Any) -> float:
    """A scalar of the first output tensor, read on the host (a full round
    trip to the device)."""
    return float(_tensors(out)[0].detach().reshape(-1)[:64].sum())


def benchmark(
    fn: Callable, *args, iters: int = 10, force_fetch: bool = True
) -> dict[str, float]:
    """Time ``fn(*args)``.

    On a card the times are CUDA events around the calls, on the CPU the
    host's clock.

    :param force_fetch: Read a scalar of the output on the host every
        iteration, so that each call's time includes the round trip. When
        ``False``, the calls are enqueued back to back and timed together
        (a throughput bound), and every entry of ``timings_ms`` is their
        mean.
    :return: Dict with ``mean_ms``, ``min_ms`` and per-iteration timings.
    """
    out = fn(*args)  # Warm-up
    on_card = _on_card(args, out)
    if on_card:
        torch.cuda.synchronize()

    def clock():
        if on_card:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def elapsed_ms(start, end) -> float:
        if on_card:
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3

    if force_fetch:
        timings = []
        for _ in range(iters):
            start = clock()
            _fetch(fn(*args))
            timings.append(elapsed_ms(start, clock()))
    else:
        start = clock()
        for _ in range(iters):
            out = fn(*args)
        timings = [elapsed_ms(start, clock()) / iters] * iters

    return {
        "mean_ms": float(np.mean(timings)),
        "min_ms": float(np.min(timings)),
        "timings_ms": timings,
    }


def timeit_slope(
    fn: Callable,
    *args,
    iters: int = 20,
    repeats: int = 5,
    min_delta: float | None = None,
    max_iters: int = 200_000,
) -> float:
    """Per-step time as the slope between ``n = 1`` and ``n = iters``
    back-to-back calls, each count timed ``repeats`` times (best kept), so
    that the fixed cost of starting and finishing a measurement cancels.
    On a card the calls are timed by CUDA events, on the CPU by the host's
    clock after the last call.

    :param min_delta: When > 0, grow the span (x10) until ``t_n - t_1 >=
        min_delta`` seconds, so that short steps are not drowned by timer
        jitter. ``None`` means 0.
    :return: Seconds per step.
    """
    min_delta = 0.0 if min_delta is None else min_delta
    on_card = _on_card(args, fn(*args))

    def run_time(n: int) -> float:
        best = np.inf
        for _ in range(repeats):
            if on_card:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(n):
                    fn(*args)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                begin = time.perf_counter()
                for _ in range(n):
                    fn(*args)
                seconds = time.perf_counter() - begin
            best = min(best, seconds)
        return best

    t_1 = run_time(1)
    n = iters
    t_n = run_time(n)
    while min_delta > 0 and (t_n - t_1) < min_delta and n * 10 <= max_iters:
        n *= 10
        t_n = run_time(n)
    return max(t_n - t_1, 1e-9) / (n - 1)


class _ByteTally(TorchDispatchMode):
    """Bytes accessed, tallied as XLA's cost analysis does per operation:
    the size of every tensor operand plus every tensor result of each
    operator that runs (a view counts its elements, not its storage)."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves((args, kwargs, out)):
            if isinstance(leaf, torch.Tensor):
                self.bytes += leaf.numel() * leaf.element_size()
        return out


def compiled_stats(fn: Callable, *args) -> dict[str, float]:
    """FLOP and memory estimates of one call of ``fn(*args)``, the
    counterpart of the compiled executable's cost analysis in the JAX
    package: ``flops`` from ``torch.utils.flop_counter`` (matrix products,
    convolutions and attention: elementwise operators count no FLOPs
    there) and ``bytes_accessed`` from a tally of every operator's operand
    and result sizes (:class:`_ByteTally`).

    The cloud-in-cell operators (``cheetah_tpu_torch::cic_*``) count as
    one operation each: their operands and results are tallied, but no
    FLOP inside them, on the card (the hand-written kernels) or on the CPU
    (their plain versions), as XLA's cost analysis counts none inside a
    Pallas custom call."""
    from torch.utils.flop_counter import FlopCounterMode

    tally = _ByteTally()
    with FlopCounterMode(display=False) as flops, tally:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(tally.bytes)}


# ---------------------------------------------------------------------------
# The spans of a finished profile
# ---------------------------------------------------------------------------

#: The name's start of the autograd engine's range around a backward node.
_ENGINE_NODE = "autograd::engine::evaluate_function: "
#: The row of :func:`span_table` for what no span holds.
UNATTRIBUTED = "unattributed"
#: The names' start of the host's CUDA API calls (``cudaLaunchKernel``,
#: ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...).
_RUNTIME_CALL = "cu"


def _host_events(profile) -> list:
    """The host's events of a finished profile, by start."""
    return sorted(
        (event for event in profile.profiler.kineto_results.events()
         if event.device_type() != torch.autograd.DeviceType.CUDA),
        key=lambda event: event.start_ns(),
    )


def _end_ns(event) -> int:
    return event.start_ns() + event.duration_ns()


def profiled_spans(profile) -> list[tuple[str, int, int, int]]:
    """The spans of a finished ``torch.profiler.profile`` as a
    :class:`Recording` gives them: ``(name, parent, start_ns, end_ns)`` in
    the order they began, ``parent`` the index of the innermost span of the
    same thread that holds it, or ``-1``."""
    found = sorted(
        (event.start_ns(), -event.duration_ns(), event.start_thread_id(), event.name())
        for event in _host_events(profile) if event.name().startswith(SPAN_PREFIX)
    )
    spans: list[tuple[str, int, int, int]] = []
    open_by_thread: dict[int, list[int]] = {}
    for start, minus_duration, thread, name in found:
        end = start - minus_duration
        stack = open_by_thread.setdefault(thread, [])
        while stack and spans[stack[-1]][3] < end:
            stack.pop()
        spans.append((name, stack[-1] if stack else -1, start, end))
        stack.append(len(spans) - 1)
    return spans


def _timeline(intervals) -> list[tuple[int, int, str | None]]:
    """Disjoint, sorted pieces ``(start, end, label)`` of the union of
    ``intervals`` (``(start, end, label)``), each piece labelled by the
    innermost interval over it; an interval that outlasts the one it began
    in is cut at that one's end."""
    pieces: list[tuple[int, int, str | None]] = []
    stack: list[tuple[int, str | None]] = []
    cursor = None

    def advance(t: int) -> None:
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, label = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, label))
                cursor = end
        if stack and t > cursor:
            pieces.append((cursor, t, stack[-1][1]))
        cursor = t if cursor is None else max(cursor, t)

    for start, end, label in sorted(intervals, key=lambda item: (item[0], -item[1])):
        advance(start)
        if stack:
            end = min(end, stack[-1][0])
        if end > start:
            stack.append((end, label))
    if stack:
        advance(stack[0][0])
    return pieces


def _label_at(pieces, starts: list[int], t: int) -> str | None:
    index = bisect.bisect_right(starts, t) - 1
    return pieces[index][2] if index >= 0 and t < pieces[index][1] else None


def span_table(profile, steps: int = 1) -> dict[str, dict[str, float]]:
    """Each span's share of a finished ``torch.profiler.profile``, a step
    (over ``steps``):

    * ``device_ms``: the device time of the operations (kernels, copies,
      fills) launched under the span;
    * ``launches``: the kernels launched under it;
    * ``idle_ms``: the time the card is idle while the span is the
      innermost on the host, between the first span's start and the last
      one's end;
    * ``host_ops``: the host's operators that begin under it.

    An operation belongs to the innermost span over the host's launch of
    it (its runtime call, by correlation id). The autograd engine's range
    around a backward node counts as ``<span>.backward`` of the span that
    ran the node's forward operation (by ``sequence_nr`` and the forward
    thread). Spans are matched by time, not by thread: the port launches
    from one thread at a time (the engine's device thread runs while the
    caller waits). The row :data:`UNATTRIBUTED` holds what no span holds."""
    host = _host_events(profile)
    spans = [(event.start_ns(), _end_ns(event), event.name()) for event in host
             if event.name().startswith(SPAN_PREFIX)]
    if not spans:
        return {}
    forward_pieces = _timeline(spans)
    forward_starts = [piece[0] for piece in forward_pieces]
    forward: dict[tuple[int, int], int] = {}
    for event in host:
        if event.sequence_nr() >= 0 and not event.name().startswith(_ENGINE_NODE):
            forward.setdefault((event.start_thread_id(), event.sequence_nr()), event.start_ns())
    nodes = []
    for event in host:
        if event.name().startswith(_ENGINE_NODE):
            start = forward.get((event.fwd_thread_id(), event.sequence_nr()))
            label = None if start is None else _label_at(forward_pieces, forward_starts, start)
            nodes.append((event.start_ns(), _end_ns(event),
                          None if label is None else label + ".backward"))
    pieces = _timeline(spans + nodes)
    starts = [piece[0] for piece in pieces]

    table: dict[str, dict[str, float]] = {}

    def row(label: str | None) -> dict[str, float]:
        return table.setdefault(label or UNATTRIBUTED,
                                {"device_ms": 0.0, "launches": 0, "idle_ms": 0.0, "host_ops": 0})

    launched = {}
    for event in host:
        name = event.name()
        if name.startswith(_RUNTIME_CALL):
            launched[event.correlation_id()] = event.start_ns()
        elif not (event.is_user_annotation() or name.startswith(_ENGINE_NODE)):
            row(_label_at(pieces, starts, event.start_ns()))["host_ops"] += 1
    window = (min(start for start, _, _ in spans), max(end for _, end, _ in spans))
    busy = []
    for event in profile.profiler.kineto_results.events():
        # The device's copies of the host's spans are no work of the card.
        if event.device_type() != torch.autograd.DeviceType.CUDA or event.is_user_annotation():
            continue
        name = event.name()
        if name.startswith(SPAN_PREFIX):
            continue
        launch = launched.get(event.correlation_id())
        entry = row(None if launch is None else _label_at(pieces, starts, launch))
        entry["device_ms"] += event.duration_ns() / 1e6
        entry["launches"] += not name.startswith(("Memcpy", "Memset"))
        busy.append((event.start_ns(), event.start_ns() + event.duration_ns()))
    for lo, hi in _idle(busy, window):
        covered = 0
        index = max(bisect.bisect_right(starts, lo) - 1, 0)
        while index < len(pieces) and pieces[index][0] < hi:
            start, end, label = pieces[index]
            overlap = min(end, hi) - max(start, lo)
            if overlap > 0:
                row(label)["idle_ms"] += overlap / 1e6
                covered += overlap
            index += 1
        row(None)["idle_ms"] += (hi - lo - covered) / 1e6
    return {label: {key: value / steps for key, value in entry.items()}
            for label, entry in sorted(table.items())}


def _idle(busy: list[tuple[int, int]], window: tuple[int, int]) -> list[tuple[int, int]]:
    """The gaps of ``window`` that no interval of ``busy`` covers."""
    gaps, cursor = [], window[0]
    for lo, hi in sorted(busy):
        if hi <= cursor:
            continue
        if lo > cursor:
            gaps.append((cursor, min(lo, window[1])))
        cursor = max(cursor, hi)
        if cursor >= window[1]:
            break
    if cursor < window[1]:
        gaps.append((cursor, window[1]))
    return [(lo, hi) for lo, hi in gaps if hi > lo]
