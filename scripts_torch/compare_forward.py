#!/usr/bin/env python3
"""Time the forward paths of two checkouts of the PyTorch port on one card,
in alternating runs, so that the host's load falls on both alike.

    python3 scripts_torch/compare_forward.py OLD_ROOT NEW_ROOT [--rounds 3]

Each round runs OLD, NEW, NEW, OLD, each in a fresh process that imports
``cheetah_tpu_torch`` from that root (and builds its kernels there at first
use). A process times the ARES EA env step (4096 instances x 10k particles,
float32), the same 4096 instances with a ``ParameterBeam`` (where the
checkout has one), the space-charge segment of
``scripts/bench_all.py:415-424`` (1M particles, 32^3, float32) and its
gradient by a drift length on 32^3 and 128^3 (chip_smoke's ``sc_grad_*``)
with CUDA events, one call per event window,
times the host's span to enqueue one call on an idle card, and profiles
five calls of each with ``torch.profiler`` for the device's busy time and
the number of kernels a call launches, and ten with ``cProfile`` for the
functions that hold the host longest. Where the checkout's kicks call the
kernels through autograd Functions, it also times the segment through the
Functions and through the bare wrappers, alternating in one process. It
prints one JSON
line per process, then one summary line with the medians of each root.
The paths and inputs are those of ``chip_smoke.py``; only APIs that every
checkout of the port has are used.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0


def _time_ms(torch, fn, runs: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(torch, fn, runs: int = 30) -> float:
    """Median host time (ms) to enqueue one call on an idle card: the card
    is synchronised before and after each call, outside the timed span."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def _host_profile(fn, calls: int = 10, top: int = 12) -> list[dict]:
    """cProfile over ``calls`` calls: the ``top`` functions by own host time,
    per call. A function that waits for the card shows its wait here."""
    import cProfile
    import pstats

    profiler = cProfile.Profile()
    profiler.enable()
    for _ in range(calls):
        fn()
    profiler.disable()
    rows = sorted(pstats.Stats(profiler).stats.items(), key=lambda item: -item[1][2])[:top]
    return [
        {
            "function": f"{file.rsplit('/', 1)[-1]}:{line}:{name}",
            "calls": primitive / calls, "own_ms": own / calls * 1e3,
            "cumulative_ms": cumulative / calls * 1e3,
        }
        for (file, line, name), (primitive, _, own, cumulative, _) in rows
    ]


def _device_busy(torch, fn, calls: int = 5) -> tuple[float, float]:
    """Device time (ms) and kernels launched, per call, over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [
        e
        for e in trace.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    return busy, sum(e.count for e in kernels) / calls


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    assert ctt.__file__.startswith(root), ctt.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def beam(num_particles):
        generator = torch.Generator(device="cuda").manual_seed(SEED)
        return ctt.ParticleBeam.from_twiss(
            num_particles=num_particles, beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9,
            beta_y=3.0, alpha_y=0.5, emittance_y=2e-9, energy=1.54e8, total_charge=1e-10,
            generator=generator, dtype=torch.float32, device="cuda",
        )

    env = ares_ea_subcell(torch.float32)
    env.AREAMQZM1.k1 = torch.linspace(-20, 20, 4096, device="cuda")
    env_beam = beam(10_000)
    kw = {"dtype": torch.float32, "device": "cuda"}
    segment = ctt.Segment(
        [
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, **kw),
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, **kw),
            ctt.Drift(0.1, **kw),
        ]
    )
    sc_beam = beam(1_000_000)
    paths = {
        "env_step": lambda: env.track(env_beam).sigma_x,
        "space_charge_segment": lambda: segment.track(sc_beam),
    }
    for grid in ((32, 32, 32), (128, 128, 128)):
        paths[f"sc_grad_{grid[0]}"] = _sc_value_and_grad(torch, ctt, grid, sc_beam, kw)
    if hasattr(ctt, "ParameterBeam"):
        moments = ctt.ParameterBeam.from_twiss(
            beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9, energy=1.54e8, **kw
        )
        paths["parameter_beam_env_step"] = lambda: env.track(moments).sigma_x
    result = {"root": root}
    for name, fn in paths.items():
        ms = _time_ms(torch, fn)
        host = _host_ms(torch, fn)
        busy, launches = _device_busy(torch, fn)
        result[name] = {
            "ms": ms, "host_ms": host, "device_busy_ms": busy, "kernels_per_call": launches,
            "host_profile": _host_profile(fn),
        }
    result["functions_vs_bare_wrappers"] = _functions_vs_bare_wrappers(
        torch, paths["space_charge_segment"]
    )
    print(json.dumps(result), flush=True)


def _sc_value_and_grad(torch, ctt, grid, sc_beam, kw):
    """sum(px^2) after the space-charge segment on ``grid`` and its
    derivative by the first drift's length, as chip_smoke's ``sc_grad_*``."""
    segment = ctt.Segment(
        [ctt.Drift(0.1, **kw), ctt.SpaceChargeKick(0.2, grid_shape=grid, **kw),
         ctt.Drift(0.1, **kw), ctt.SpaceChargeKick(0.2, grid_shape=grid, **kw),
         ctt.Drift(0.1, **kw)]
    )
    length = torch.tensor(0.1, device="cuda", requires_grad=True)
    segment.elements[0].length = length

    def value_and_grad():
        value = torch.sum(torch.square(segment.track(sc_beam).px))
        return value, torch.autograd.grad(value, length)

    return value_and_grad


def _functions_vs_bare_wrappers(torch, fn, alternations: int = 6) -> dict | None:
    """In a checkout whose kicks call the CIC kernels through autograd
    Functions, the segment's event time through the Functions and through
    the bare wrappers (patched in for the span), alternating in one
    process; None in a checkout without the Functions."""
    from cheetah_tpu_torch.ops import cic_kernels

    if not hasattr(cic_kernels, "differentiable_gather"):
        return None
    functions = (cic_kernels.differentiable_gather, cic_kernels.differentiable_deposit)
    bare = (cic_kernels.gather_multi_3d, cic_kernels.deposit_multi_3d)
    times = {"functions": [], "bare_wrappers": []}
    for _ in range(alternations):
        for label, (gather, deposit) in (("functions", functions), ("bare_wrappers", bare)):
            cic_kernels.differentiable_gather, cic_kernels.differentiable_deposit = gather, deposit
            times[label].append(_time_ms(torch, fn, runs=10, warmup=2))
    cic_kernels.differentiable_gather, cic_kernels.differentiable_deposit = functions
    return {label: statistics.median(values) for label, values in times.items()} | {
        "all": times
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.old)
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    # Absolute roots: each worker runs in its own root and imports from it.
    args.old, args.new = os.path.abspath(args.old), os.path.abspath(args.new)
    runs = {args.old: [], args.new: []}
    for _ in range(args.rounds):
        for root in (args.old, args.new, args.new, args.old):
            start = time.perf_counter()
            out = subprocess.run(
                [sys.executable, __file__, root, root, "--worker"],
                capture_output=True, text=True, timeout=600, cwd=root,
            )
            if out.returncode != 0:
                print(out.stderr, file=sys.stderr)
                return out.returncode
            line = json.loads(out.stdout.strip().splitlines()[-1])
            line["seconds"] = time.perf_counter() - start
            print(json.dumps(line), flush=True)
            runs[root].append(line)

    # The paths both checkouts time.
    paths = [
        path for path in runs[args.old][0]
        if isinstance(runs[args.old][0][path], dict) and "ms" in runs[args.old][0][path]
        and path in runs[args.new][0]
    ]
    summary = {"nvidia_smi": smi}
    for label, root in (("old", args.old), ("new", args.new)):
        summary[label] = {
            path: {
                key: statistics.median(run[path][key] for run in runs[root])
                for key in ("ms", "host_ms", "device_busy_ms", "kernels_per_call")
            }
            for path in paths
        }
    summary["new_over_old"] = {
        path: {
            key: summary["new"][path][key] / summary["old"][path][key]
            for key in ("ms", "host_ms", "device_busy_ms")
        }
        for path in paths
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
