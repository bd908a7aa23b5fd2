"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (the kernels' build or load, the
lattice, the beam and the inputs drawn on the card from ``--seed``, the
warm-up steps) counts as ``setup_s``; then steps run back to back for
``--seconds``. With ``--trace 0`` the last line of standard output holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from ``torch.profiler`` over a window of the mix's ``trace_steps`` steps.
Either way the results of a sample of the window's steps, drawn from the
seed, are compared with the plain reference in float64 once the window has
closed; each number compared is printed with its limit as the last lines
of standard error and under ``checks``, the line's last key.

Exits non-zero and prints no result without a card, with fewer cards than
the cell asks for, or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    # Fixed cache directories inside the checkout, so that only a
    # checkout's first run compiles.
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "inductor")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    import cheetah_tpu_torch  # noqa: F401  (the system under test; absent, the run fails here)
    from portbench import harness

    with open(ROOT / "BENCHMARK.json") as handle:
        cell = harness.load_cell(args.workload, json.load(handle), BENCH_DIR)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}.",
              file=sys.stderr)
        return 2
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                           PROCESS_START)
    found = harness.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    report(run)
    return 0


def report(run) -> None:
    """The run's notes, then each number compared beside its limit as the
    last lines of standard error, then the result as the last line of
    standard output."""
    for note in run.notes:
        print(json.dumps(note))
    sys.stdout.flush()
    for name, check in run.checks.items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(run.line()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
