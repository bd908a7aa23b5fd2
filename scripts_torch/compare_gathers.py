#!/usr/bin/env python3
"""Time the CIC gathers of two checkouts of the PyTorch port on one card, at
the shapes of the space-charge paths, by two methods, in alternating runs.

    python3 scripts_torch/compare_gathers.py OLD_ROOT NEW_ROOT [--rounds 1]

Each round runs OLD, NEW, NEW, OLD, each in a fresh process that imports
``cheetah_tpu_torch`` from that root (and builds its kernels there at first
use). A process makes 1M particles of a Gaussian beam on a grid of +-3
sigma and random float32 grids from a seed, as ``chip_smoke.py`` does, and
times ``cic_kernels.gather_multi_3d`` (the public gather: the untiled kernel
at 32^3, the x-tiled one with its plan at 128^3) at the paths' order sets
(value C=3, raised C=3, raised C=1), the plan alone at 128^3, and
``grid_sample`` on the value set. Each is timed three ways:

- ``graph_ms``: 10 calls captured in a CUDA graph, replayed between CUDA
  events (median of 20): the card's time alone;
- ``eager_ms``: 10 back-to-back calls between CUDA events (median of 20),
  so the host's time to enqueue a call counts where it exceeds the card's;
- ``host_ms``: the host's time to enqueue one call on an idle card
  (median of 30).

It prints one JSON line per process, then one summary line with the medians
of each root and the ratios NEW / OLD. Only APIs that every checkout of the
port since its gradient slice has are used.
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
NUM_PARTICLES = 1_000_000
RAISED = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
ORDER_SETS = {"value_c3": (((0, 0, 0),), 3), "raised_c3": (RAISED, 3), "raised_c1": (RAISED, 1)}
METHODS = ("graph_ms", "eager_ms", "host_ms")


def _eager_ms(torch, fn, calls: int = 10, runs: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _graph_ms(torch, fn, calls: int = 10, runs: int = 20) -> float:
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
    return _eager_ms(torch, graph.replay, calls=1, runs=runs) / calls


def _host_ms(torch, fn, runs: int = 30) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def _methods(torch, fn) -> dict:
    return {
        "graph_ms": _graph_ms(torch, fn),
        "eager_ms": _eager_ms(torch, fn),
        "host_ms": _host_ms(torch, fn),
    }


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import cheetah_tpu_torch
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    assert cheetah_tpu_torch.__file__.startswith(root), cheetah_tpu_torch.__file__
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    result = {"root": root}
    for side in (32, 128):
        shape = (side, side, side)
        n = torch.tensor(shape, dtype=torch.float32, device="cuda")
        gauss = torch.randn((1, NUM_PARTICLES, 3), generator=generator, device="cuda")
        nodes = n / 2 + gauss * n / 6
        grids = torch.randn((1, 3, *shape), generator=generator, device="cuda")
        timed = {}
        for label, (orders, components) in ORDER_SETS.items():
            values = grids[:, :components].contiguous()
            timed[label] = _methods(
                torch, lambda: cic_kernels.gather_multi_3d(values, nodes, orders)
            )
        scale = torch.tensor([side - 1] * 3, dtype=torch.float32, device="cuda")
        sample_grid = (nodes.flip(-1) / scale * 2 - 1).view(1, 1, 1, NUM_PARTICLES, 3)
        timed["grid_sample_value_c3"] = _methods(
            torch,
            lambda: torch.nn.functional.grid_sample(
                grids, sample_grid, mode="bilinear", padding_mode="zeros", align_corners=True
            ),
        )
        if cic_kernels.uses_tiled(shape):
            plan = getattr(cic_tiled, "plan_tiles", cic_tiled.tile_plan)
            timed["plan"] = _methods(torch, lambda: plan(nodes, shape))
        result[f"{side}^3"] = timed
    print(json.dumps(result), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--rounds", type=int, default=1)
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
            out = subprocess.run(
                [sys.executable, __file__, root, root, "--worker"],
                capture_output=True, text=True, timeout=600, cwd=root,
            )
            if out.returncode != 0:
                print(out.stderr, file=sys.stderr)
                return out.returncode
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[root].append(line)

    summary = {"nvidia_smi": smi}
    for label, root in (("old", args.old), ("new", args.new)):
        summary[label] = {
            grid: {
                name: {
                    method: statistics.median(run[grid][name][method] for run in runs[root])
                    for method in METHODS
                }
                for name in timed
            }
            for grid, timed in runs[root][0].items()
            if grid != "root"
        }
    summary["new_over_old"] = {
        grid: {
            name: {
                method: summary["new"][grid][name][method] / summary["old"][grid][name][method]
                for method in METHODS
            }
            for name in timed
        }
        for grid, timed in summary["new"].items()
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
