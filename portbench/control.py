"""The readings that the limits of ``portbench/limits/`` are set from, on
the card, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For each of ``--seeds`` one run of the program (set-up, a window of
``--seconds``, the comparison of the sampled steps with the float64
reference), and for each of ``--control-seeds`` the control: the plain
reference computed in float32 with TF32 matrix products (the precision
below the configuration's float32, whose matrix products are full float32)
put in the program's place, on the steps a run compares, and compared the
same way. Prints one JSON line a reading and, last, the largest reading of
the program and the smallest of the control for each number.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))


def control_readings(cell, seed: int, device="cuda") -> dict:
    """The control's reading of each number over as many steps as a run
    compares (from the pool), aggregated as a run's are."""
    import torch

    import cheetah_tpu_torch as ctt
    from portbench import harness
    from portbench.reference import optics

    steps = harness.make_steps(ctt, cell, seed, device)
    steps.release()
    readings = []
    count = int(cell.traffic["steps_compared"])
    first = int(cell.traffic["warmup_steps"])
    for index in harness.sampled_steps(seed, count, count):
        with optics.tf32_products():
            lowered = steps.reference(first + index, torch.float32)
        expected = steps.reference(first + index, torch.float64)
        readings.append({key: float(value) for key, value in
                         steps.readings(first + index, lowered, expected).items()})
    return harness.aggregate(steps, readings)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with open(BENCH_DIR.parent / "BENCHMARK.json") as handle:
        cell = harness.load_cell(args.workload, json.load(handle), BENCH_DIR)
    program: dict[str, float] = {}
    control: dict[str, float] = {}
    for seed in args.seeds:
        run = harness.run_cell(cell, seed, args.seconds, False, "cuda")
        readings = {key: check["value"] for key, check in run.checks.items()}
        print(json.dumps({"workload": cell.name, "side": "program", "seed": seed,
                          "steps": run.attempted, "readings": readings}), flush=True)
        for key, value in readings.items():
            program[key] = max(program.get(key, 0.0), value)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        readings = control_readings(cell, seed)
        print(json.dumps({"workload": cell.name, "side": "control", "seed": seed,
                          "readings": readings}), flush=True)
        for key, value in readings.items():
            control[key] = min(control.get(key, float("inf")), value)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "program_max": program, "control_min": control,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
