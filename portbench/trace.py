"""What a traced window holds, read from ``torch.profiler``'s Kineto events:
the device's operations with their intervals, the host's operations, the
window's own span and the program's counters. The per-layer metrics and the
result's ``breakdown`` read it."""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_SPAN = "portbench.window"
#: Longest name kept in a breakdown entry.
NAME_CHARACTERS = 90


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    kind: str  # "kernel", "memcpy", "memset" or another device activity

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Trace:
    """A traced window: ``steps`` steps between ``window_ns``."""

    window_ns: tuple[int, int]
    steps: int
    device_ops: list[DeviceOp]
    host_ops: list[tuple[str, int, int]]
    counters: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    #: The host clock's numbers of an untraced window run before this one
    #: (:func:`portbench.harness.host_numbers`), or ``None``.
    host: dict | None = None

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def kernels(self) -> list[DeviceOp]:
        return [op for op in self.device_ops if op.kind == "kernel"]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint intervals."""
        start, end = self.window_ns
        spans = sorted((max(op.start_ns, start), min(op.end_ns, end))
                       for op in self.device_ops if op.end_ns > start and op.start_ns < end)
        merged: list[list[int]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e9


def _kind(event) -> str:
    activity = str(getattr(event, "activity_type", lambda: "")()).lower()
    name = event.name().lower()
    if "annotation" in activity:
        return "annotation"
    if "memcpy" in activity or name.startswith("memcpy"):
        return "memcpy"
    if "memset" in activity or name.startswith("memset"):
        return "memset"
    if "kernel" in activity or activity == "":
        return "kernel"
    return activity


def read(profile, steps: int, counters: dict, config: dict, traffic: dict,
         host: dict | None = None) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    window is the span named :data:`WINDOW_SPAN`."""
    import torch

    events = profile.profiler.kineto_results.events()
    spans = {event.name() for event in events if event.device_type() != torch.autograd.DeviceType.CUDA
             and event.is_user_annotation()} | {WINDOW_SPAN}
    device_ops, host_ops, window = [], [], None
    for event in events:
        start, duration = event.start_ns(), event.duration_ns()
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _kind(event)
            # The device's copies of the host's spans are no device work.
            if kind in ("kernel", "memcpy", "memset") and event.name() not in spans:
                device_ops.append(DeviceOp(event.name(), start, start + duration, kind))
        elif event.name() == WINDOW_SPAN:
            window = (start, start + duration)
        else:
            host_ops.append((event.name(), start, start + duration))
    if window is None:
        raise RuntimeError(f"The trace holds no {WINDOW_SPAN} span.")
    return Trace(window, steps, device_ops, host_ops, counters, config, traffic, host)


def _short(name: str) -> str:
    """A kernel's function name: no return type, template arguments or
    parameters, cut to length."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:NAME_CHARACTERS]
    plain, depth = [], 0
    for char in name.replace("(anonymous namespace)", "anonymous"):
        depth += (char == "<") - (char == ">")
        if depth == 0 and char != ">":
            plain.append(char)
    words = "".join(plain).split("(")[0].split()
    return (words[-1] if words else name)[:NAME_CHARACTERS]


def breakdown(trace: Trace, entries: int = 10, gaps_named: int = 200) -> dict:
    """The device operations that took most time (summed by name), and the
    idle time of the window's ``gaps_named`` longest idle gaps summed by
    what the host was doing: the innermost host operation under each gap's
    midpoint."""
    import numpy as np

    by_op: dict[str, float] = {}
    for op in trace.device_ops:
        key = _short(op.name)
        by_op[key] = by_op.get(key, 0.0) + op.seconds
    gaps = []
    previous = trace.window_ns[0]
    for lo, hi in trace.busy_intervals() + [(trace.window_ns[1], trace.window_ns[1])]:
        if lo > previous:
            gaps.append((previous, lo))
        previous = max(previous, hi)
    gaps = sorted(gaps, key=lambda gap: gap[0] - gap[1])[:gaps_named]
    names = [op[0] for op in trace.host_ops]
    starts = np.array([op[1] for op in trace.host_ops], dtype=np.int64)
    ends = np.array([op[2] for op in trace.host_ops], dtype=np.int64)
    by_host: dict[str, float] = {}
    for lo, hi in gaps:
        middle = (lo + hi) // 2
        under = np.flatnonzero((starts <= middle) & (ends >= middle))
        name = (names[under[np.argmin(ends[under] - starts[under])]][:NAME_CHARACTERS]
                if under.size else "(no host op)")
        by_host[name] = by_host.get(name, 0.0) + (hi - lo) / 1e9
    return {
        "device_ops": [[name, seconds] for name, seconds in
                       sorted(by_op.items(), key=lambda item: -item[1])[:entries]],
        "idle_gaps": [[name, seconds] for name, seconds in
                      sorted(by_host.items(), key=lambda item: -item[1])[:entries]],
    }
