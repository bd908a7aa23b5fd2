#!/usr/bin/env python3
"""Count the operators that one call of a path of the PyTorch port
dispatches, on the CPU: a count that predicts the path's kernel launches on
the card before a chip run (the launches of one call are its non-view
operators, one kernel each, for the plain-PyTorch paths).

    python3 scripts_torch/count_ops.py [--particles 64]

Counts one call of each mode of the ARES stage-3 lattice
(``lattices.ares_stage3``: ``ParticleBeam`` in linear, second-order and
drift-kick-drift mode, ``ParameterBeam`` in linear mode), the ARES linac
imported from its NX Tables export with the magnets chip_smoke.py's
``imported_ares`` phase sets, the Elegant FODO and cavity lattices and the
Bmad tutorial lattice, and, for calibration against earlier chip runs, the
ARES EA env step. The count does not depend on the number of particles.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

#: Operators that launch no kernel on the card.
NO_KERNEL = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "empty", "empty_like",
             "empty_strided", "_to_copy", "copy_", "lift_fresh_copy", "_unsafe_view"}


class CountOps(TorchDispatchMode):
    """Counts the non-view operators dispatched inside the block."""

    def __init__(self) -> None:
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not func.is_view and name not in NO_KERNEL:
            self.count += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    fn()  # caches (identity maps, index tensors) are filled once
    with CountOps() as counter:
        fn()
    return counter.count


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--particles", type=int, default=64)
    args = parser.parse_args()

    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.lattices import ares_ea_subcell, ares_stage3

    warnings.simplefilter("ignore")  # the tracking-method fallbacks, apertures
    cpu = {"dtype": torch.float32, "device": "cpu"}
    beam = ctt.ParticleBeam.from_twiss(
        num_particles=args.particles, beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9, beta_y=3.0,
        alpha_y=0.5, emittance_y=2e-9, energy=1.54e8, total_charge=1e-10,
        generator=torch.Generator().manual_seed(0), **cpu,
    )
    parameter_beam = ctt.ParameterBeam.from_twiss(
        beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9, energy=1.54e8, **cpu
    )
    counts = {}
    env = ares_ea_subcell(**cpu)
    env.AREAMQZM1.k1 = torch.linspace(-20, 20, 4, dtype=torch.float32)
    counts["env_step"] = count(lambda: env.track(beam).sigma_x)
    segment = ares_stage3(**cpu)
    plans = {}
    for mode in ("linear", "second_order", "drift_kick_drift"):
        segment.set_attrs_on_every_element(tracking_method=mode, num_steps=5)
        plans[mode] = len(segment._plan())
        counts[f"stage3_{mode}"] = count(lambda: segment.track(beam).particles)
    segment.set_attrs_on_every_element(tracking_method="linear")
    counts["stage3_parameter_beam"] = count(lambda: segment.track(parameter_beam).sigma_x)

    resources = pathlib.Path(__file__).resolve().parents[1] / "tests" / "resources"
    imported = ctt.Segment.from_nx_tables(resources / "Stage4v3_9.txt", **cpu)
    # chip_smoke.py's seeded magnets: k1 in +-5, angles in +-1e-4, seed 0.
    rng = np.random.default_rng(0)
    quadrupoles = [e for e in imported.elements if isinstance(e, ctt.Quadrupole)]
    correctors = [e for e in imported.elements
                  if isinstance(e, (ctt.HorizontalCorrector, ctt.VerticalCorrector))]
    for quadrupole, k1 in zip(quadrupoles, rng.uniform(-5.0, 5.0, len(quadrupoles))):
        quadrupole.k1 = float(k1)
    for corrector, angle in zip(correctors, rng.uniform(-1e-4, 1e-4, len(correctors))):
        corrector.angle = float(angle)
    plans["imported_ares"] = len(imported._plan())
    counts["imported_ares"] = count(lambda: imported.track(beam).particles)
    files = {
        "fodo": lambda: ctt.Segment.from_elegant(resources / "fodo.lte", "fodo", **cpu),
        "cavity": lambda: ctt.Segment.from_elegant(resources / "cavity.lte", "cavity", **cpu),
        "bmad_tutorial": lambda: ctt.Segment.from_bmad(
            resources / "bmad_tutorial_lattice.bmad", **cpu),
    }
    for name, build in files.items():
        lattice = build()
        counts[name] = count(lambda: lattice.track(beam).particles)
    print(json.dumps({"dispatched_ops": counts, "plan_entries": plans}))


if __name__ == "__main__":
    main()
