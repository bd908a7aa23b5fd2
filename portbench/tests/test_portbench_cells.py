"""Each cell end to end at a tiny size on the CPU, through the kernels'
plain versions, and the command's behaviour around it."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.helpers import CELLS, ROOT, tiny_cell

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, trace):
    cell = tiny_cell(name)
    run = harness.run_cell(cell, 2**31 + 17, 0.3, trace, "cpu")
    line = run.line()
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert run.attempted > 0 and run.failed == 0
    assert run.correct, run.checks
    assert set(run.checks) == set(cell.limits)
    if trace:
        # No card: no device metric is read, none is made up; the host
        # clock's per-layer numbers come from the untraced window before.
        host = {m["name"] for m in cell.per_layer if m["source"] == "host_clock"}
        assert set(line["metrics"]) == host and line["device"]["busy_s"] == 0.0
        assert all(line["metrics"][name]["value"] > 0 for name in host)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "peak_mem_gib")


def test_same_seed_same_inputs():
    cell = tiny_cell("ares_ea.env_step")
    import cheetah_tpu_torch as ctt

    first = harness.make_steps(ctt, cell, 99, "cpu")
    second = harness.make_steps(ctt, cell, 99, "cpu")
    other = harness.make_steps(ctt, cell, 100, "cpu")
    assert torch.equal(first.settings, second.settings)
    assert torch.equal(first.beam.particles, second.beam.particles)
    assert not torch.equal(first.settings, other.settings)
    # Consecutive steps never reuse inputs.
    assert not torch.equal(first.settings[0], first.settings[1])


def test_sampled_steps_include_the_last():
    chosen = harness.sampled_steps(5, 40, 4)
    assert len(chosen) == 4 and chosen[-1] == 39 and chosen == sorted(set(chosen))
    assert harness.sampled_steps(5, 1, 4) == [0]


def test_percentile_is_the_tail_of_all_steps():
    values = list(np.linspace(1.0, 100.0, 100))
    assert harness.percentile(values, 0.95) == pytest.approx(95.05)


def test_command_without_a_card_fails_and_prints_no_result():
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ares_ea.env_step", "--seed",
         "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert '"correct"' not in done.stdout


def test_command_prints_the_line_last(monkeypatch, capsys):
    from portbench import run as command

    cell = tiny_cell("ares_ea.moments_step")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "load_cell", lambda *args, **kw: cell)
    run_cell = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda cell, seed, seconds, trace, device, start:
                        run_cell(cell, seed, seconds, trace, "cpu"))
    assert command.main(["--workload", cell.name, "--seed", "3", "--seconds", "0.2",
                         "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == LINE_KEYS + ["checks"]
    assert line["checks"]["reward_rel_err"]["limit"] == cell.limits["reward_rel_err"]
    assert err.strip().splitlines()[-1].startswith("check reward_rel_err ")
