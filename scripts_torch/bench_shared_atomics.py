#!/usr/bin/env python3
"""Time shared-memory float atomics against int32 fixed-point atomics on one
card, the measurement behind the privatised deposits' int32 windows
(``cheetah_tpu_torch/csrc/cic_common.cuh`` SharedWindow).

    python3 scripts_torch/bench_shared_atomics.py

Builds ``scripts_torch/shared_atomics.cu`` with nvcc for sm_90a into
``cheetah_tpu_torch/build/`` and runs it on Gaussian and uniform cells. It
prints the card's name and power limit, then one JSON line per cell
distribution and kind of add.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from cheetah_tpu_torch.ops import nvcc  # noqa: E402


def main() -> int:
    source = pathlib.Path(__file__).resolve().parent / "shared_atomics.cu"
    binary = nvcc.BUILD_DIR / "shared_atomics"
    binary.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [nvcc._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(binary),
         str(source)],
        check=True, timeout=600,
    )
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    for cells in ("gaussian", "uniform"):
        subprocess.run([str(binary), cells], check=True, timeout=120)
    return 0


if __name__ == "__main__":
    sys.exit(main())
