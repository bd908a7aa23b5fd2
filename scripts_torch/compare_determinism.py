#!/usr/bin/env python3
"""Whether two checkouts of the PyTorch port repeat their results bit for
bit on one card: the checks of ``chip_smoke.py``'s determinism phase and of
its space-charge line, run on each tree without stopping at a failure.

    python3 scripts_torch/compare_determinism.py OLD_ROOT NEW_ROOT

Each root runs in a fresh process that imports ``cheetah_tpu_torch`` from
that root (building its kernels there) and this checkout's ``chip_smoke``
for its cases and helpers, and reports:

- ``deposits``: every deposit route three times on identical inputs
  (``chip_smoke.deposit_repeats``: the grids 16^3 to 128^3 and the tiled
  checks' grids, float32 and float64, B 1 and 4, the value and raised order
  sets, C 1 and 3, a Gaussian and a crowded beam): the cases, and those
  whose outputs differ between runs;
- ``sc_line_32`` and ``sc_line_128``: the cold-beam space-charge line at 1M
  particles (``lattices.cold_beam_line``, 10 kicks), its float32 gradient
  by ``track`` over 5 runs (the values and their spread) and by
  ``track_checkpointed``, and both in float64;
- ``screens``: each screen reading of ``chip_smoke.SCREEN_CASES`` taken
  twice on the 100k beam, equal or not.

It prints the card's name and power limit, one JSON line per root, then a
summary of the failed checks per root. Only APIs that the port has had
since its structure slice are used.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.ops import cic_kernels

    assert ctt.__file__.startswith(root), ctt.__file__
    smoke = _chip_smoke()
    result = {"root": root}
    cases = [case for case, *_ in smoke.deposit_repeats(cic_kernels)]
    result["deposits"] = {"cases": len(cases),
                          "differ": [case for case in cases if not case["bits_equal"]]}
    for grid in ((32, 32, 32), (128, 128, 128)):
        beam, line = smoke._cold_line(ctt, smoke.SC_LINE_KICKS, grid)
        runs = [smoke._line_value_and_grad(line, beam, smoke._first_length(line), "track")[1]
                .item() for _ in range(5)]
        checkpointed = smoke._line_value_and_grad(line, beam, smoke._first_length(line),
                                                  "track_checkpointed")[1].item()
        _, line64 = smoke._cold_line(ctt, smoke.SC_LINE_KICKS, grid, torch.float64)
        beam64 = beam.to(dtype=torch.float64)
        grads64 = [smoke._line_value_and_grad(line64, beam64, smoke._first_length(line64),
                                              method)[1].item()
                   for method in ("track", "track_checkpointed")]
        result[f"sc_line_{grid[0]}"] = {
            "track_f32": runs,
            "spread_f32": (max(runs) - min(runs)) / abs(statistics.mean(runs)),
            "checkpointed_f32": checkpointed, "checkpointed_equal_f32": checkpointed == runs[0],
            "track_f64": grads64[0], "checkpointed_f64": grads64[1],
            "checkpointed_equal_f64": grads64[0] == grads64[1],
        }
        del beam, line, line64, beam64
    result["screens"] = smoke._screen_repeats(ctt)
    print(json.dumps(result), flush=True)


def _failed(result: dict) -> list:
    failed = [
        "deposit {grid} {dtype} B{batch} {orders} C{components} {beam}".format(**case)
        for case in result["deposits"]["differ"]
    ]
    for grid in (32, 128):
        line = result[f"sc_line_{grid}"]
        if line["spread_f32"] != 0.0:
            failed.append(f"sc_line_{grid}: track's f32 gradient spread {line['spread_f32']}")
        for dtype in ("f32", "f64"):
            if not line[f"checkpointed_equal_{dtype}"]:
                failed.append(f"sc_line_{grid}: checkpointed {dtype} gradient differs")
    failed += [f"screen {screen}" for screen in result["screens"] if not screen["bits_equal"]]
    return failed


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old")
    parser.add_argument("new")
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
    summary = {"nvidia_smi": smi}
    for label, root in (("old", os.path.abspath(args.old)), ("new", os.path.abspath(args.new))):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), root, root, "--worker"],
                             capture_output=True, text=True, timeout=900, cwd=root)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(result), flush=True)
        failed = _failed(result)
        summary[label] = {"deposit_cases": result["deposits"]["cases"],
                          "failed_checks": len(failed), "failed": failed}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
