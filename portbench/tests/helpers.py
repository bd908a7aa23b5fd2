"""Tiny cells for the CPU tests: the cells of ``BENCHMARK.json`` with
their configurations cut to a few instances, particles and grid cells."""

import json
import pathlib

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("ares_ea.env_step", "sc_segment_128.grad", "ares_ea.env_grad_step",
         "ares_ea.moments_step")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(name: str, particles: int = 2000, instances: int = 16, grid: int = 16):
    cell = harness.load_cell(name, benchmark())
    cell.config["beam"]["num_particles"] = particles
    if "instances" in cell.config:
        cell.config["instances"] = instances
    for element in cell.config["lattice"]:
        if "grid_shape" in element:
            element["grid_shape"] = [grid, grid, grid]
    cell.traffic["trace_steps"] = 2
    if "particles_compared" in cell.traffic:
        cell.traffic["particles_compared"] = 128
    return cell
