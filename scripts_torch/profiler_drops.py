#!/usr/bin/env python3
"""How often torch.profiler loses kernel records of an eager space-charge
step on one card, by the way the trace is opened, before and after the
process has run Inductor's code and a CUDA-graph tree.

    python3 scripts_torch/profiler_drops.py

Steps: the 128^3 space-charge gradient and the 32^3 segment at 1M
particles (``chip_smoke``'s cases). Ways: ``plain`` (one call in the
trace), ``warmup`` (the schedule's warm-up step first, as
``chip_smoke._profiled_cic_kernels``), ``plain_sleep`` (0.1 s before the
trace stops), ``pad_sleep`` (a spin kernel before and after the call as
well) and ``three`` (three calls). Each way runs 8 times a stage; each
stage prints one JSON line: by step and way, the distinct CIC kernel
counts by name and how often each came, those of the raw kineto events by
family, and the distinct totals of kernel records with their frequency.
The step is the same every time, so a total that varies is records lost.
"""
from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: Runs of each way per stage.
TRIALS = 8
ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def counts(trace) -> tuple[dict, dict, int]:
    """The CIC kernels' records by name, the raw kineto events' by family,
    and the kernel records in all."""
    by_name = collections.Counter()
    total = 0
    for e in trace.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += e.count
        if any(piece in e.key for pieces in cs.KERNEL_FAMILIES.values() for piece in pieces):
            by_name[cs._kernel_name(e.key)] += e.count
    raw = collections.Counter()
    for event in trace.profiler.kineto_results.events():
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            for family, pieces in cs.KERNEL_FAMILIES.items():
                if any(piece in event.name() for piece in pieces):
                    raw[family] += 1
    return dict(by_name), dict(raw), total


def plain(fn, sleep: float = 0.0, pad: bool = False, calls: int = 1):
    """``calls`` calls of ``fn`` in one trace, a spin kernel before and after
    them where ``pad``, ``sleep`` seconds before the trace stops."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as trace:
        if pad:
            torch.cuda._sleep(100000)
            torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if pad:
            torch.cuda._sleep(100000)
            torch.cuda.synchronize()
        if sleep:
            time.sleep(sleep)
    return counts(trace)


def warmup(fn):
    """One call of ``fn`` traced after the schedule's warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as trace:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            trace.step()
    return counts(trace)


WAYS = {
    "plain": plain,
    "warmup": warmup,
    "plain_sleep": lambda fn: plain(fn, 0.1),
    "pad_sleep": lambda fn: plain(fn, 0.1, True),
    "three": lambda fn: plain(fn, 0.1, True, 3),
}


def run(stage: str, steps: dict) -> None:
    """Every way on every step ``TRIALS`` times, interleaved; one line."""
    results = collections.defaultdict(list)
    for _ in range(TRIALS):
        for step_name, step in steps.items():
            for way_name, way in WAYS.items():
                results[f"{step_name}/{way_name}"].append(way(step))
    summary = {
        key: {
            "distinct": dict(collections.Counter(json.dumps(r[0], sort_keys=True) for r in rows)),
            "raw": dict(collections.Counter(json.dumps(r[1], sort_keys=True) for r in rows)),
            "totals": sorted(collections.Counter(r[2] for r in rows).items()),
        }
        for key, rows in results.items()
    }
    print(json.dumps({"stage": stage, "summary": summary}), flush=True)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    cs.phase_build([cic_kernels.LIBRARY, cic_tiled.LIBRARY])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, "torch", torch.__version__, flush=True)
    generator = torch.Generator(device="cuda").manual_seed(cs.SEED)
    beam = cs._bench_beam(ctt, cs.NUM_PARTICLES, "cuda", generator)
    segment128 = cs._sc_segment(ctt, torch.float32, "cuda", (128, 128, 128))
    segment32 = cs._sc_segment(ctt, torch.float32, "cuda", (32, 32, 32))
    steps = {"sc_grad_128": lambda: cs._sc_value_and_grad(segment128, beam, 0.1),
             "sc_segment_32": lambda: segment32.track(beam)}
    start = time.time()
    run("quiet", steps)
    print("quiet s", time.time() - start, flush=True)
    # Inductor, Triton and a CUDA-graph tree in this process, as in a
    # process that compiles the paths.
    compiled = torch.compile(lambda x: (x * 2 + 1).sin().sum(), fullgraph=True)
    graphed = torch.compile(lambda x: (x * 3 + 1).cos().sum(), fullgraph=True,
                            mode="reduce-overhead")
    x = torch.randn(1000, device="cuda")
    for _ in range(4):
        compiled(x)
        torch.compiler.cudagraph_mark_step_begin()
        graphed(x)
    torch.cuda.synchronize()
    print("compiled s", time.time() - start, flush=True)
    run("after_inductor", steps)
    print("done s", time.time() - start, flush=True)


if __name__ == "__main__":
    main()
