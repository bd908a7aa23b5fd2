"""The benchmark's harness: cells found by name, inputs made from the seed,
the measured window, the traced window and the comparison with the plain
reference.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names its files:
``configs/<config>.json`` (the lattice and the beam as data),
``traffic/<mix>.json`` (what a step calls and how its inputs are drawn),
``limits/<cell>.json`` (the limit of each number that decides ``correct``)
and, for each per-layer metric the cell reports, ``metrics/<metric>.py``
(a reader with ``read(trace) -> float | None``). A traffic file's
``entry`` names its step kind, ``steps/<entry>.py``: the inputs drawn from
the mix's parameters, the step, its plain reference and the numbers
compared.

Every step is one closed loop: the host reads the step's result back
before the next step starts, and each step takes the next inputs of a pool
that set-up draws on the device.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import trace as tracing

BENCH_DIR = pathlib.Path(__file__).resolve().parent
#: Modules a run may not hold, compared by their top-level name.
BANNED_MODULES = ("jax", "jaxlib", "flax", "cheetah_tpu")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    bench_dir: pathlib.Path = BENCH_DIR


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as handle:
        return json.load(handle)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict, bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``benchmark`` (the parsed ``BENCHMARK.json``)."""
    workloads = {workload["name"]: workload for workload in benchmark["workloads"]}
    if name not in workloads:
        raise KeyError(f"No workload {name!r} in BENCHMARK.json: {sorted(workloads)}")
    workload = workloads[name]
    return Cell(
        name=name,
        config=_read_json(bench_dir / "configs" / f"{workload['config']}.json"),
        traffic=_read_json(bench_dir / "traffic" / f"{workload['traffic']}.json"),
        chips=int(workload["chips"]),
        end_to_end=[m for m in benchmark["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in benchmark["per_layer"] if _reports(m, name)],
        limits=_read_json(bench_dir / "limits" / f"{name}.json"),
        bench_dir=bench_dir,
    )


def _load(path: pathlib.Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(bench_dir: pathlib.Path, name: str):
    """``metrics/<name>.py``: its ``read(trace)`` gives the metric or
    ``None``; an optional ``note(trace)`` gives what the run prints beside
    it on an earlier line. A name ``<quantity>.<part>`` with no file of its
    own (one quantity split by the end-to-end metric it moves) is read by
    ``metrics/<quantity>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    return _load(path, f"portbench_metric_{name.replace('.', '_')}")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED_MODULES))


# ---------------------------------------------------------------------------
# Inputs from the seed
# ---------------------------------------------------------------------------


def derived_seed(seed: int, stream: int) -> int:
    """A seed for one stream of random numbers of a run."""
    return (int(seed) * 1_000_003 + stream) % 2**63


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, stream))


def twiss_covariance(beam: dict) -> torch.Tensor:
    """The 7x7 covariance (float64) of the Gaussian beam the configuration
    states by its Twiss parameters, uncorrelated ``tau`` and ``p``."""
    cov = torch.zeros(7, 7, dtype=torch.float64)
    for offset, plane in ((0, "x"), (2, "y")):
        beta, alpha, emittance = (beam[f"{key}_{plane}"] for key in ("beta", "alpha", "emittance"))
        cov[offset, offset] = emittance * beta
        cov[offset, offset + 1] = cov[offset + 1, offset] = -emittance * alpha
        cov[offset + 1, offset + 1] = emittance * (1 + alpha**2) / beta
    cov[4, 4] = beam["sigma_tau"] ** 2
    cov[5, 5] = beam["sigma_p"] ** 2
    return cov


def make_particles(beam: dict, seed: int, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(particles (N, 7), charges (N,))`` of the configuration's beam,
    drawn on ``device`` from the seed in one call."""
    count = int(beam["num_particles"])
    factor = torch.linalg.cholesky(twiss_covariance(beam)[:6, :6]).to(device=device, dtype=dtype)
    normal = torch.randn((count, 6), generator=generator(seed, 1, device), dtype=dtype,
                         device=device)
    particles = torch.cat([normal @ factor.T, torch.ones(count, 1, dtype=dtype, device=device)],
                          dim=1)
    charges = torch.full((count,), beam["total_charge"] / count, dtype=dtype, device=device)
    return particles, charges


def build_segment(ctt, config: dict, dtype, device):
    """The configuration's lattice through the port's public element
    classes, as a user who imports a lattice builds it."""
    elements = []
    for element in config["lattice"]:
        kwargs = {key: value for key, value in element.items() if key != "type"}
        if "grid_shape" in kwargs:
            kwargs["grid_shape"] = tuple(kwargs["grid_shape"])
        elements.append(getattr(ctt, element["type"])(**kwargs, dtype=dtype, device=device))
    return ctt.Segment(elements, name=config["name"])


# ---------------------------------------------------------------------------
# Step kinds
# ---------------------------------------------------------------------------


def steps_module(bench_dir: pathlib.Path, entry: str):
    """``steps/<entry>.py``, the step kind a traffic file's ``entry`` names."""
    return _load(bench_dir / "steps" / f"{entry}.py", f"portbench_steps_{entry}")


def make_steps(ctt, cell: Cell, seed: int, device, dtype=torch.float32):
    """The step kind's ``Steps`` for ``cell``: set-up of its inputs from the
    seed, ``step(index)``, ``reference(index, dtype)``, ``readings(index,
    result, expected)`` and ``release()``."""
    return steps_module(cell.bench_dir, cell.traffic["entry"]).Steps(ctt, cell, seed, device,
                                                                      dtype)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(steps, first: int, seconds: float, max_steps: int | None = None):
    """Steps back to back from pool index ``first`` until ``seconds`` have
    passed (or ``max_steps`` are done). Returns the host results, each
    step's duration in seconds and the window's length."""
    results, durations = [], []
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while end < deadline and (max_steps is None or len(results) < max_steps):
        begin = time.perf_counter()
        results.append(steps.step(first + len(results)))
        end = time.perf_counter()
        durations.append(end - begin)
    return results, durations, end - start


def _by_second(durations) -> list[float]:
    """The mean step time (ms) of each second of the window, in order."""
    means, elapsed, bucket = [], 0.0, []
    for duration in durations:
        bucket.append(duration)
        elapsed += duration
        if elapsed >= len(means) + 1:
            means.append(round(sum(bucket) / len(bucket) * 1e3, 3))
            bucket = []
    return means + ([round(sum(bucket) / len(bucket) * 1e3, 3)] if bucket else [])


def host_numbers(durations, window_s: float) -> dict:
    """``step_ms`` (the window over the steps it completed) and
    ``step_p95_ms`` (the 95th percentile of every step) by the host's clock."""
    return {"step_ms": window_s / len(durations) * 1e3,
            "step_p95_ms": percentile(durations, 0.95) * 1e3}


def percentile(values, share: float) -> float:
    """The ``share`` quantile of ``values`` (``statistics.quantiles``,
    inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[round(share * 100) - 1]


def cic_counters() -> dict:
    """The port's CIC launch counters by wrapper."""
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    return {
        "deposit_multi_3d": cic_kernels.deposit_multi_3d.launches,
        "gather_multi_3d": cic_kernels.gather_multi_3d.launches,
        "deposit_multi_tiled_3d": cic_tiled.deposit_multi_tiled_3d.launches,
        "gather_multi_tiled_3d": cic_tiled.gather_multi_tiled_3d.launches,
        "plan_tiles": cic_tiled.plan_tiles.launches,
    }


def nvidia_smi() -> dict | None:
    """The card's name, clocks, power and temperature, or ``None`` where
    ``nvidia-smi`` is missing."""
    fields = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {"fields": fields, "cards": [line.strip() for line in out.splitlines() if line.strip()]}


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """What one run measured and compared."""

    metrics: dict = field(default_factory=dict)
    device: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    breakdown: dict | None = None
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and self.attempted > 0 and all(
            math.isfinite(check["value"]) and check["value"] <= check["limit"]
            for check in self.checks.values())

    def line(self) -> dict:
        line = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
                "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            line["breakdown"] = self.breakdown
        line["checks"] = self.checks
        return line


def sampled_steps(seed: int, count: int, wanted: int) -> list[int]:
    """The window's steps whose results are compared, drawn from the seed,
    the last step among them."""
    rng = np.random.default_rng(derived_seed(seed, 4))
    chosen = set(rng.choice(count, size=min(wanted, count), replace=False).tolist())
    chosen.discard(count - 1)
    return sorted(chosen)[: max(wanted - 1, 0)] + [count - 1]


def aggregate(steps, readings: list[dict]) -> dict:
    """Each number over the compared steps: the worst, or the root mean
    square for the step kind's ``RMS_NUMBERS``."""
    rms = getattr(steps, "RMS_NUMBERS", ())
    return {key: (math.sqrt(sum(r[key] ** 2 for r in readings) / len(readings)) if key in rms
                  else max(r[key] for r in readings))
            for key in readings[0]}


def compare(steps, results, first: int, cell: Cell, seed: int, dtype=torch.float64) -> dict:
    """Each number of :meth:`readings` over the sampled steps
    (:func:`aggregate`), with its limit."""
    readings = []
    for index in sampled_steps(seed, len(results), int(cell.traffic["steps_compared"])):
        expected = steps.reference(first + index, dtype)
        readings.append({key: float(value) for key, value in
                         steps.readings(first + index, results[index], expected).items()})
    numbers = aggregate(steps, readings)
    if set(numbers) != set(cell.limits):
        raise KeyError(f"{cell.name}: the step kind reads {sorted(numbers)}, the limits name "
                       f"{sorted(cell.limits)}")
    return {key: {"value": value, "limit": float(cell.limits[key])}
            for key, value in numbers.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             process_start: float | None = None) -> Run:
    """One run of ``cell``: set-up, warm-up, the window (traced with
    ``trace``), then the comparison with the reference."""
    import cheetah_tpu_torch as ctt

    begin = time.perf_counter()
    process_start = begin if process_start is None else process_start
    cuda = torch.device(device).type == "cuda"
    run = Run()
    traffic = cell.traffic
    steps = make_steps(ctt, cell, seed, device)
    _synchronize(device)
    made = time.perf_counter()
    warmup = int(traffic["warmup_steps"])
    for index in range(warmup):
        steps.step(index)
    _synchronize(device)
    run.notes.append({"setup_phases_s": {"imports": begin - process_start,
                                         "inputs": made - begin,
                                         "warmup": time.perf_counter() - made}})
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - process_start

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        # Where the cell reports host-clock numbers per layer, an untraced
        # window of ``seconds`` comes first and they are read from it.
        host, results = None, []
        if any(metric["source"] == "host_clock" for metric in cell.per_layer):
            results, durations, window_s = run_window(steps, warmup, seconds)
            host = host_numbers(durations, window_s)
        smi_before = nvidia_smi() if cuda else None
        counters_before = cic_counters()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as profiled:
            with record_function(tracing.WINDOW_SPAN):
                traced, durations, window_s = run_window(
                    steps, warmup + len(results), seconds, int(traffic["trace_steps"]))
                _synchronize(device)
        counters = {key: value - counters_before[key] for key, value in cic_counters().items()}
        run.notes.append({"nvidia_smi_before": smi_before, "nvidia_smi_after": nvidia_smi()
                          if cuda else None, "untraced_steps": len(results), "host": host,
                          "traced_steps": len(traced), "cic_launches": counters})
        results = results + traced
    else:
        results, durations, window_s = run_window(steps, warmup, seconds)
    _synchronize(device)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.attempted = len(results)
    run.failed = sum(not all(np.isfinite(part).all() for part in result) for result in results)
    run.device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }

    if trace:
        window = tracing.read(profiled, len(traced), counters, cell.config, traffic, host)
        del profiled
        run.device["busy_s"] = window.busy_s()
        run.device["window_s"] = window.window_s
        for metric in cell.per_layer:
            module = metric_module(cell.bench_dir, metric["name"])
            value = module.read(window)
            if value is not None:
                run.metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
                if hasattr(module, "note"):
                    run.notes.append({metric["name"]: module.note(window)})
        run.breakdown = tracing.breakdown(window)
    else:
        host = host_numbers(durations, window_s)
        measured = {**host, "peak_mem_gib": window_peak / 2**30, "setup_s": setup_s}
        for metric in cell.end_to_end:
            run.metrics[metric["name"]] = {"value": measured[metric["name"]],
                                           "unit": metric["unit"]}
        run.notes.append({"nvidia_smi_after": nvidia_smi() if cuda else None,
                          "setup_peak_gib": setup_peak / 2**30, "steps": len(results),
                          "host": host, "step_ms_by_second": _by_second(durations)})

    # The reference runs once the window has closed, its peak read and the
    # program's state released.
    steps.release()
    if cuda:
        torch.cuda.empty_cache()
    start = time.perf_counter()
    run.checks = compare(steps, results, warmup, cell, seed)
    run.notes.append({"compare_s": time.perf_counter() - start})
    return run
