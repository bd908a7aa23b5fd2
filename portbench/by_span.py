"""Where a cell's step spends its time on the card, by the program's spans.

    python3 portbench/by_span.py --workload <cell> --seed <n> [--steps <n>]

From the root of a checkout whose port has the spans of
``cheetah_tpu_torch.utils.profiling``. Set-up and warm-up as in a run of
the cell (``portbench/run.py``); then three windows of ``--steps`` steps
each (the mix's ``trace_steps`` by default), every step a closed loop as in
the benchmark:

1. ``untraced``: the host's step time (``step_ms``, ``step_p95_ms``);
2. ``recorded``: the same with the spans on their host-clock sink
   (``profiling.recording()``, the profiler off), and each span's count
   and host ms a step (a span nested in one of its own name counted once);
3. ``traced``: under ``torch.profiler``, ``profiling.span_table``: each
   span's device ms, kernel launches, idle ms and host operators a step,
   the autograd engine's work under ``<span>.backward``; the port's
   counters over the window; and the cell's per-layer metrics of
   ``BENCHMARK.json`` read from the same trace.

Prints one JSON line a window, the card's name and power limit on each.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))


def measure(cell, seed: int, steps: int, device="cuda"):
    """The three windows' lines, and the finished profile of the traced one."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.utils import profiling
    from portbench import harness
    from portbench import trace as tracing

    cuda = torch.device(device).type == "cuda"
    step_kind = harness.make_steps(ctt, cell, seed, device)
    first = int(cell.traffic["warmup_steps"])
    for index in range(first):
        step_kind.step(index)
    harness._synchronize(device)
    card = harness.nvidia_smi() if cuda else None

    def window():
        nonlocal first
        _, durations, window_s = harness.run_window(step_kind, first, float("inf"), steps)
        harness._synchronize(device)
        first += steps
        return harness.host_numbers(durations, window_s)

    lines = [{"workload": cell.name, "window": "untraced", "steps": steps, "card": card,
              "host": window()}]
    with profiling.recording() as recorded:
        host = window()
    lines.append({"workload": cell.name, "window": "recorded", "steps": steps, "host": host,
                  "spans": {name: {"count": row["count"] / steps, "host_ms": row["ms"] / steps}
                            for name, row in recorded.summary().items()}})
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = profiling.counters()
    with profile(activities=activities) as profiled:
        with record_function(tracing.WINDOW_SPAN):
            host = window()
    counters = {key: value - before.get(key, 0) for key, value in profiling.counters().items()}
    read = tracing.read(profiled, steps, counters, cell.config, cell.traffic)
    metrics = {}
    for metric in cell.per_layer:
        if metric["source"] == "device_trace":
            value = harness.metric_module(cell.bench_dir, metric["name"]).read(read)
            metrics[metric["name"]] = None if value is None else float(value)
    lines.append({"workload": cell.name, "window": "traced", "steps": steps, "host": host,
                  "counters": counters, "metrics": metrics,
                  "span_table": profiling.span_table(profiled, steps)})
    step_kind.release()
    return lines, profiled


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with open(BENCH_DIR.parent / "BENCHMARK.json") as handle:
        cell = harness.load_cell(args.workload, json.load(handle), BENCH_DIR)
    lines, _ = measure(cell, args.seed, args.steps or int(cell.traffic["trace_steps"]))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
