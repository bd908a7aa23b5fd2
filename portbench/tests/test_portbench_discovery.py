"""A configuration, a traffic mix, a per-layer metric, a cell's limits, a
step kind and an element type's reference map added as files in a copy of
the benchmark are found by name, with no file of the harness edited."""

import json
import shutil
import subprocess
import sys

from portbench.tests.helpers import ROOT

RUN_ONE_CELL = """
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
from portbench import harness
bench = json.load(open(sys.argv[1] + "/BENCHMARK.json"))
cell = harness.load_cell(sys.argv[3], bench, harness.BENCH_DIR)
assert str(harness.BENCH_DIR).startswith(sys.argv[1]), harness.BENCH_DIR
run = harness.run_cell(cell, 2**31 + 3, 0.2, True, "cpu")
print(json.dumps(run.line()))
"""


STEP_KIND = """
import numpy as np
import torch

from portbench import harness
from portbench.reference import optics


class Steps:
    def __init__(self, ctt, cell, seed, device, dtype):
        beam = cell.config["beam"]
        self.lattice = cell.config["lattice"]
        self.energy = float(torch.tensor(beam["energy"], dtype=dtype))
        self.particles, charges = harness.make_particles(beam, seed, dtype, device)
        self.beam = ctt.ParticleBeam(self.particles, energy=beam["energy"],
                                     particle_charges=charges, dtype=dtype, device=device)
        self.segment = harness.build_segment(ctt, cell.config, dtype, device)

    def step(self, index):
        return (self.segment.track(self.beam).particles[:, 0].cpu().numpy(),)

    def reference(self, index, dtype):
        particles = self.particles.to(dtype)
        for element in self.lattice:
            values = {key: torch.as_tensor(value, dtype=dtype) for key, value in element.items()
                      if isinstance(value, float)}
            R = optics.element_map(element, values, self.energy, 1, dtype, particles.device)
            particles = optics.transport(particles, R[0])
        return (particles[:, 0].cpu().numpy(),)

    def readings(self, index, result, expected):
        return {"x_err": float(np.max(np.abs(result[0] - expected[0]))
                               / np.max(np.abs(expected[0])))}

    def release(self):
        del self.segment, self.beam
"""

IDENTITY_MAP = """
import torch


def transfer_map(element, values, energy, batch, dtype, device):
    return torch.eye(7, dtype=dtype, device=device).repeat(batch, 1, 1)
"""


def _copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return tmp_path / "portbench"


def _run(tmp_path, bench, cell):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return subprocess.run([sys.executable, "-c", RUN_ONE_CELL, str(tmp_path), str(ROOT), cell],
                          capture_output=True, text=True, timeout=300)


def test_new_files_are_found_by_name(tmp_path):
    bench_dir = _copy(tmp_path)
    config = json.loads((bench_dir / "configs" / "ares_ea.json").read_text())
    config.update(name="dummy", instances=4)
    config["lattice"] = config["lattice"][:5]
    config["tunables"] = config["tunables"][:2]
    config["beam"]["num_particles"] = 300
    (bench_dir / "configs" / "dummy.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "env_step.json").read_text())
    mix.update(pool=4, trace_steps=2, steps_compared=2)
    (bench_dir / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "dummy_metric.py").write_text(
        "def read(trace):\n    return 1000.0 + trace.steps\n")
    (bench_dir / "limits" / "dummy.dummy_mix.json").write_text(
        json.dumps({"reward_rel_err": 1e-4, "reward_err_of_moments": 1e-4,
                    "reward_rel_err_all": 1e-3}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "test", "reduced": [],
                             "file": "portbench/configs/dummy.json", "why": "test"})
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "Device",
                               "moves": "step_ms", "workloads": ["dummy.dummy_mix"]})
    done = _run(tmp_path, bench, "dummy.dummy_mix")
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["metrics"]["dummy_metric"] == {"value": 1002.0, "unit": "x"}
    assert line["correct"] is True


def test_new_step_kind_and_element_map_are_found_by_name(tmp_path):
    bench_dir = _copy(tmp_path)
    config = {"name": "bpm_line", "dtype": "float32",
              "lattice": [{"type": "Drift", "name": "D1", "length": 0.5},
                          {"type": "BPM", "name": "M1"},
                          {"type": "Drift", "name": "D2", "length": 0.3}],
              "beam": {**json.loads((bench_dir / "configs" / "ares_ea.json").read_text())["beam"],
                       "num_particles": 500}}
    (bench_dir / "configs" / "bpm_line.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "forward.json").write_text(json.dumps(
        {"entry": "forward", "warmup_steps": 1, "trace_steps": 2, "steps_compared": 2}))
    (bench_dir / "steps" / "forward.py").write_text(STEP_KIND)
    (bench_dir / "limits" / "bpm_line.forward.json").write_text(json.dumps({"x_err": 1e-5}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bpm_line", "source": "test", "reduced": [],
                             "file": "portbench/configs/bpm_line.json", "why": "test"})
    bench["workloads"].append({"name": "bpm_line.forward", "config": "bpm_line",
                               "traffic": "forward", "chips": 1, "why": "test"})
    # The reference has no map of a BPM until its file is added.
    done = _run(tmp_path, bench, "bpm_line.forward")
    assert done.returncode != 0 and "no first-order map of a BPM" in done.stderr
    (bench_dir / "reference" / "maps").mkdir()
    (bench_dir / "reference" / "maps" / "BPM.py").write_text(IDENTITY_MAP)
    done = _run(tmp_path, bench, "bpm_line.forward")
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and set(line["checks"]) == {"x_err"}
