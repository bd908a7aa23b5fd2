"""Profiling helpers (counterpart of ``cheetah_tpu/utils/profiling.py``).

A trace on ``torch.profiler``; timers that use CUDA events when the work
runs on a card and the host's clock when it runs on the CPU; and the
FLOPs and bytes of one call (the counterpart of XLA's cost analysis).
Each function keeps the JAX function's return contract.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the host and, where a card is present, of the
    device, written to ``log_dir`` for TensorBoard or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        yield


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
