#!/usr/bin/env python3
"""Time the CIC deposits of two checkouts of the PyTorch port on one card, at
the shapes of the space-charge paths, by three methods, in alternating runs.

    python3 scripts_torch/compare_deposits.py OLD_ROOT NEW_ROOT [--rounds 1]

Each round runs OLD, NEW, NEW, OLD, each in a fresh process that imports
``cheetah_tpu_torch`` from that root (and builds its kernels there at first
use). A process makes 1M particles of a Gaussian beam on a grid of +-3
sigma, at the deposit's cell-centre convention, and random float32 rows
from a seed, as ``chip_smoke.py`` does, and times, at the value order with
C = 1 (the charge, forward) and C = 3 (the force gradients, backward):

- ``cic_kernels.deposit_multi_3d`` at 32^3 and 64^3 (the untiled kernel),
  and at 32^3 in float64 (``32^3_f64``, its route into global memory);
- at 128^3, ``cic_tiled.deposit_multi_tiled_3d`` making its plan
  (``tiled``) and given the plan made before (``tiled_kernel``), and the
  untiled kernel on the same inputs (``untiled``, C = 1 only).

Each is timed three ways:

- ``graph_ms``: 10 calls captured in a CUDA graph, replayed between CUDA
  events (median of 20): the card's time alone;
- ``eager_ms``: 10 back-to-back calls between CUDA events (median of 20),
  so the host's time to enqueue a call counts where it exceeds the card's;
- ``host_ms``: the host's time to enqueue one call on an idle card
  (median of 30).

It prints the card's name and power limit, one JSON line per process, then
one summary line with the medians of each root and the ratios NEW / OLD.
Only APIs that every checkout of the port since its plan slice has are used.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from compare_gathers import METHODS, _methods

SEED = 0
NUM_PARTICLES = 1_000_000
VALUE = ((0, 0, 0),)


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import cheetah_tpu_torch
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    assert cheetah_tpu_torch.__file__.startswith(root), cheetah_tpu_torch.__file__
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    result = {"root": root}
    for side in (32, 64, 128):
        shape = (side, side, side)
        n = torch.tensor(shape, dtype=torch.float32, device="cuda")
        gauss = torch.randn((1, NUM_PARTICLES, 3), generator=generator, device="cuda")
        positions = n / 2 - 0.5 + gauss * n / 6
        timed = {}
        for components in (1, 3):
            rows = torch.randn((1, 1, components, NUM_PARTICLES), generator=generator,
                               device="cuda")
            if not cic_kernels.uses_tiled(shape):
                timed[f"c{components}"] = _methods(
                    torch, lambda: cic_kernels.deposit_multi_3d(positions, rows, shape, VALUE)
                )
                continue
            plan = cic_tiled.plan_tiles(positions, shape)
            timed[f"tiled_c{components}"] = _methods(
                torch, lambda: cic_tiled.deposit_multi_tiled_3d(positions, rows, shape, VALUE)
            )
            timed[f"tiled_kernel_c{components}"] = _methods(
                torch,
                lambda: cic_tiled.deposit_multi_tiled_3d(positions, rows, shape, VALUE,
                                                         plan=plan),
            )
            if components == 1:
                timed["untiled_c1"] = _methods(
                    torch, lambda: cic_kernels._deposit_untiled(positions, rows, shape, VALUE)
                )
        result[f"{side}^3"] = timed
    shape = (32, 32, 32)
    n = torch.tensor(shape, dtype=torch.float64, device="cuda")
    gauss = torch.randn((1, NUM_PARTICLES, 3), generator=generator, dtype=torch.float64,
                        device="cuda")
    positions = n / 2 - 0.5 + gauss * n / 6
    timed = {}
    for components in (1, 3):
        rows = torch.randn((1, 1, components, NUM_PARTICLES), generator=generator,
                           dtype=torch.float64, device="cuda")
        timed[f"c{components}"] = _methods(
            torch, lambda: cic_kernels.deposit_multi_3d(positions, rows, shape, VALUE)
        )
    result["32^3_f64"] = timed
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
                [sys.executable, os.path.abspath(__file__), root, root, "--worker"],
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
