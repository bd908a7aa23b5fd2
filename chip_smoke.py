#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cheetah_tpu_torch``) on one NVIDIA card.

Run from the root of the repository with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``cheetah_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card, drives the two
paths of the port (the ARES EA env step and the 1M-particle space-charge
segment) through the public entry points, checks them against the port's
own float64 run on the CPU, and times kernels and paths with CUDA events.
Every phase prints one JSON line. The last line is
``{"ok": true, "device": {...}}``; any failed check raises, so the script
exits non-zero and prints no such line. It imports neither JAX nor the JAX
package, and it refuses to run without a card.

Precision: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False, so float32 matrix
products run in full float32.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time

import torch

#: Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

NUM_PARTICLES = 1_000_000
ALL_ORDERS = tuple(itertools.product((0, 1), repeat=3))
SEED = 0

# Tolerances of the kernels against their plain versions on the card, as a
# fraction of max|output|. The gather sums 8 corner terms per output in the
# same order as its plain version; only FMA contraction differs, a few ulps.
# The deposit adds ~N * 8 / cells (~250 at 32^3) terms per cell with
# atomics in an order that changes from run to run, as does index_add_ in
# the plain version; sqrt(250) * eps * max|term| stays well below 1e-5 of
# max|output|, and K * eps * max|term| (the worst case) near it.
GATHER_TOLERANCE = 1e-5
DEPOSIT_TOLERANCE = 1e-4
# The card (float32) against the port on the CPU (float64): sigma_x of the
# env step to rtol 1e-4 (a 13-matrix product and a raw-moment variance over
# 10k particles in float32, ~1e-6 expected); the space-charge kicks to an RMS
# error of 1e-4 of the RMS kick in px and py (float32 deposit rounding and
# grid edges that move with float32 beam sizes, ~2e-6 on the CPU at 200k
# particles) and 1e-3 in p, where the float32 SI round trip adds
# eps * gamma0 / (beta0 gamma0) = 6e-8 per particle (~1.5e-5 on the CPU).
ENV_STEP_RTOL = 1e-4
KICK_RMS_TOLERANCE = {"px": 1e-4, "py": 1e-4, "p": 1e-3}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def time_ms(fn, runs: int = 20, warmup: int = 3, per_event: int = 1) -> float:
    """Median time of one call of ``fn`` on the card, with CUDA events around
    ``per_event`` back-to-back calls, over ``runs`` such windows. A kernel is
    timed with ``per_event`` > 1, so that the host's time to enqueue one call
    hides behind the previous call instead of counting as device time; a
    whole path is timed call by call, as its user calls it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_event):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_event)
    return statistics.median(times)


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it."""
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = operations / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def relative_error(actual: torch.Tensor, expected: torch.Tensor) -> tuple[float, float]:
    """(max |actual - expected|, that divided by max |expected|)."""
    absolute = (actual.double() - expected.double()).abs().max().item()
    return absolute, absolute / expected.double().abs().max().item()


def profile_path(label: str, fn, ms: float) -> None:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``), and
    the device's idle share against ``ms``, the call's CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: a CPU op's entry repeats the device time of
    # the kernels it launched.
    kernels = [
        e
        for e in trace.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit(
        "profile",
        path=label,
        event_ms=ms,
        device_busy_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / ms),
        kernel_launches=sum(e.count for e in kernels),
        top=[
            {"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
            for e in top
        ],
    )


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        "environment",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        nvidia_smi=smi,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
    )
    return smi


def phase_build(cic_kernels) -> None:
    start = time.perf_counter()
    cic_kernels.build(verbose=True)
    emit("build", seconds=time.perf_counter() - start, library=str(cic_kernels.library_path()))


def _uniform_positions(generator, batch, shape, dtype):
    """Bin-space positions spilling past every edge, with parked (-2),
    far-out and non-finite particles mixed in."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    normalized = (
        torch.rand((batch, NUM_PARTICLES, 3), generator=generator, dtype=dtype, device="cuda")
        * (n + 2.0)
        - 1.5
    )
    normalized[:, ::97] = -2.0
    normalized[:, 1::1009, 0] = float("nan")
    normalized[:, 2::1009, 1] = float("inf")
    normalized[:, 3::1009, 2] = -1e30
    return normalized


def _beam_positions(generator, shape, offset, dtype):
    """Bin-space positions of a Gaussian beam on a grid of +-3 sigma, as the
    space-charge kick gives them (``offset`` -0.5 for the deposit's cell
    centres, 0 for the gather's nodes)."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    gauss = torch.randn((1, NUM_PARTICLES, 3), generator=generator, dtype=dtype, device="cuda")
    return n / 2 + offset + gauss * n / 6


def phase_kernels(cic_kernels) -> dict:
    """Each kernel against its plain version on the card, at all 8 orders
    for B in {1, 4} and grids 32^3 and 64^3, then timed at the main path's
    shape. Returns the numbers for the ``kernels`` line."""
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"deposit": 0.0, "gather": 0.0}
    for batch, side, dtype in [
        (1, 32, torch.float32), (4, 32, torch.float32),
        (1, 64, torch.float32), (4, 64, torch.float32),
        (1, 32, torch.float64),
    ]:
        shape = (side, side, side)
        normalized = _uniform_positions(generator, batch, shape, dtype)
        rows = torch.randn(
            (batch, len(ALL_ORDERS), 1, NUM_PARTICLES), generator=generator,
            dtype=dtype, device="cuda",
        )
        got = cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS)
        want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, ALL_ORDERS)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "deposit produced non-finite values")
        _, deposit_error = relative_error(got, want)
        ms_deposit = time_ms(
            lambda: cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS),
            per_event=10,
        )

        grids = torch.randn(
            (batch, 3, *shape), generator=generator, dtype=dtype, device="cuda"
        )
        got = cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS)
        want = cic_kernels.gather_multi_3d_reference(grids, normalized, ALL_ORDERS)
        torch.cuda.synchronize()
        gather_error = max(relative_error(g, w)[1] for g, w in zip(got, want))
        check(all(bool(torch.isfinite(g).all()) for g in got), "gather produced non-finite values")
        ms_gather = time_ms(
            lambda: cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS), per_event=10
        )
        # Bytes each kernel must move: positions, rows or grids read once,
        # outputs written once.
        size = normalized.element_size()
        cells = side**3
        orders = len(ALL_ORDERS)
        deposit_bytes = size * batch * (NUM_PARTICLES * (3 + orders) + cells)
        gather_bytes = size * batch * (3 * cells + NUM_PARTICLES * (3 + 3 * orders))
        emit(
            "kernel_check",
            batch=batch, grid=list(shape), particles=NUM_PARTICLES, orders=orders,
            dtype=str(dtype).removeprefix("torch."),
            deposit_rel_err=deposit_error, deposit_ms=ms_deposit,
            deposit_bound_ms=bound(deposit_bytes, batch * NUM_PARTICLES * 8 * 5 * orders)[0],
            gather_components=3, gather_rel_err=gather_error, gather_ms=ms_gather,
            gather_bound_ms=bound(gather_bytes, batch * NUM_PARTICLES * 3 * 8 * 4 * orders)[0],
        )
        check(deposit_error <= DEPOSIT_TOLERANCE, f"deposit error {deposit_error}")
        check(gather_error <= GATHER_TOLERANCE, f"gather error {gather_error}")
        worst["deposit"] = max(worst["deposit"], deposit_error)
        worst["gather"] = max(worst["gather"], gather_error)
        del normalized, rows, grids, got, want

    # The main path's shape: one instance, 32^3, 1M particles, the value
    # order; the deposit carries the charge (C=1), the gather the three
    # force components (C=3).
    shape = (32, 32, 32)
    f32 = torch.float32
    cells = shape[0] * shape[1] * shape[2]
    positions = _beam_positions(generator, shape, -0.5, f32)
    charges = torch.rand((1, 1, 1, NUM_PARTICLES), generator=generator, dtype=f32, device="cuda")
    got = cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE)
    want = cic_kernels.deposit_multi_3d_reference(positions, charges, shape, cic_kernels.VALUE)
    deposit_abs, deposit_rel = relative_error(got, want)
    check(deposit_rel <= DEPOSIT_TOLERANCE, f"deposit error {deposit_rel} at the main shape")
    deposit_ms = time_ms(
        lambda: cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE),
        per_event=10,
    )
    deposit_plain_ms = time_ms(
        lambda: cic_kernels.deposit_multi_3d_reference(positions, charges, shape, cic_kernels.VALUE),
        per_event=10,
    )
    deposit_bound = bound(
        NUM_PARTICLES * (3 + 1) * 4 + cells * 4, NUM_PARTICLES * 8 * 5
    )

    nodes = _beam_positions(generator, shape, 0.0, f32)
    grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
    (got,) = cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE)
    (want,) = cic_kernels.gather_multi_3d_reference(grids, nodes, cic_kernels.VALUE)
    gather_abs, gather_rel = relative_error(got, want)
    check(gather_rel <= GATHER_TOLERANCE, f"gather error {gather_rel} at the main shape")
    gather_ms = time_ms(
        lambda: cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE), per_event=10
    )
    gather_plain_ms = time_ms(
        lambda: cic_kernels.gather_multi_3d_reference(grids, nodes, cic_kernels.VALUE),
        per_event=10,
    )
    gather_bound = bound(
        cells * 3 * 4 + NUM_PARTICLES * 3 * 4 + NUM_PARTICLES * 3 * 4,
        NUM_PARTICLES * 3 * 8 * 4,
    )

    # Yardstick, timed only: grid_sample (trilinear, zero padding) computes
    # the order-0 gather in one call. Its input is (B, C, D, H, W) = (1, 3,
    # nx, ny, nt) and its grid's last axis is (t, y, x) scaled to [-1, 1].
    scale = torch.tensor([shape[2] - 1, shape[1] - 1, shape[0] - 1], dtype=f32, device="cuda")
    sample_grid = (nodes.flip(-1) / scale * 2 - 1).view(1, 1, 1, NUM_PARTICLES, 3)

    def library_gather():
        return torch.nn.functional.grid_sample(
            grids, sample_grid, mode="bilinear", padding_mode="zeros", align_corners=True
        )

    library = library_gather().view(1, 3, NUM_PARTICLES)
    _, library_rel = relative_error(library, want)
    gather_library_ms = time_ms(library_gather, per_event=10)

    emit(
        "kernel_main_shape",
        grid=list(shape), particles=NUM_PARTICLES,
        deposit={"ms": deposit_ms, "plain_ms": deposit_plain_ms, "bound_ms": deposit_bound[0],
                 "max_abs_err": deposit_abs, "rel_err": deposit_rel},
        gather={"ms": gather_ms, "plain_ms": gather_plain_ms, "bound_ms": gather_bound[0],
                "library_ms": gather_library_ms, "grid_sample_rel_diff": library_rel,
                "max_abs_err": gather_abs, "rel_err": gather_rel},
        worst_rel_err_all_orders=worst,
    )
    return {
        "deposit": dict(
            ms=deposit_ms, plain_ms=deposit_plain_ms, bound_ms=deposit_bound[0],
            bound_by=deposit_bound[1], library_ms=None, max_abs_err=deposit_abs,
        ),
        "gather": dict(
            ms=gather_ms, plain_ms=gather_plain_ms, bound_ms=gather_bound[0],
            bound_by=gather_bound[1], library_ms=gather_library_ms, max_abs_err=gather_abs,
        ),
    }


def _bench_beam(ctt, num_particles, device, generator):
    """The Twiss beam of the JAX package's benchmarks (``bench.py``)."""
    return ctt.ParticleBeam.from_twiss(
        num_particles=num_particles, beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9,
        beta_y=3.0, alpha_y=0.5, emittance_y=2e-9, energy=1.54e8, total_charge=1e-10,
        generator=generator, dtype=torch.float32, device=device,
    )


def phase_env_step(ctt, cic_kernels) -> None:
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances, num_particles = 4096, 10_000
    segment = ares_ea_subcell(torch.float32)
    segment.AREAMQZM1.k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, num_particles, "cuda", generator)
    num_elements = len(segment.elements)

    cic_kernels.deposit_multi_3d.launches = 0
    cic_kernels.gather_multi_3d.launches = 0
    sigma_x = segment.track(beam).sigma_x
    torch.cuda.synchronize()
    launches = (cic_kernels.deposit_multi_3d.launches, cic_kernels.gather_multi_3d.launches)
    check(tuple(sigma_x.shape) == (num_instances,), f"sigma_x shape {tuple(sigma_x.shape)}")
    check(bool(torch.isfinite(sigma_x).all()), "non-finite sigma_x")

    picks = torch.linspace(0, num_instances - 1, 8).round().long()
    reference = ares_ea_subcell(torch.float64, device="cpu")
    reference.AREAMQZM1.k1 = segment.AREAMQZM1.k1[picks.cuda()].cpu().double()
    expected = reference.track(beam.to("cpu", torch.float64)).sigma_x
    actual = sigma_x[picks.cuda()].cpu().double()
    error = ((actual - expected).abs() / expected).max().item()
    check(error <= ENV_STEP_RTOL, f"env step sigma_x off by {error} relative")

    ms = time_ms(lambda: segment.track(beam).sigma_x, runs=20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_path("env_step", lambda: segment.track(beam).sigma_x, ms)
    emit(
        "env_step",
        instances=num_instances, particles=num_particles, elements=num_elements,
        ms=ms, transports_per_s=num_instances * num_particles * num_elements / (ms * 1e-3),
        sigma_x_rel_err_vs_cpu_f64=error, kernel_launches=list(launches),
        peak_memory_gib=peak,
    )


def _sc_segment(ctt, dtype, device):
    """The space-charge segment of the JAX package's benchmark
    (``scripts/bench_all.py``): Drift-Kick-Drift-Kick-Drift on a 32^3 grid."""
    kw = {"dtype": dtype, "device": device}
    return ctt.Segment(
        [
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, **kw),
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, **kw),
            ctt.Drift(0.1, **kw),
        ]
    )


def _check_kicks(label, beam_in, out_card, out_cpu) -> dict:
    before = beam_in.to("cpu", torch.float64).particles
    errors = {}
    for index, name in ((1, "px"), (3, "py"), (5, "p")):
        kick_cpu = out_cpu.particles[..., index] - before[..., index]
        kick_card = out_card.particles[..., index].cpu().double() - before[..., index]
        rms = torch.sqrt(torch.mean(kick_cpu**2)).item()
        error = torch.sqrt(torch.mean((kick_card - kick_cpu) ** 2)).item() / rms
        errors[name] = error
        check(error <= KICK_RMS_TOLERANCE[name], f"{label}: {name} kick off by {error} RMS")
    return errors


def phase_space_charge(ctt, cic_kernels) -> tuple[int, int]:
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
    segment = _sc_segment(ctt, torch.float32, "cuda")

    cic_kernels.deposit_multi_3d.launches = 0
    cic_kernels.gather_multi_3d.launches = 0
    out = segment.track(beam)
    torch.cuda.synchronize()
    launches = (cic_kernels.deposit_multi_3d.launches, cic_kernels.gather_multi_3d.launches)
    check(launches == (2, 2), f"space-charge segment launched {launches}, not (2, 2)")
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles after the kicks")

    start = time.perf_counter()
    out_cpu = _sc_segment(ctt, torch.float64, "cpu").track(beam.to("cpu", torch.float64))
    cpu_seconds = time.perf_counter() - start
    errors = _check_kicks("segment", beam, out, out_cpu)
    ms = time_ms(lambda: segment.track(beam), runs=10)
    profile_path("space_charge_segment", lambda: segment.track(beam), ms)
    emit(
        "space_charge_segment",
        particles=NUM_PARTICLES, grid=[32, 32, 32], kicks=2, ms=ms,
        launches={"deposit": launches[0], "gather": launches[1]},
        kick_rms_rel_err_vs_cpu_f64=errors, cpu_f64_seconds=cpu_seconds,
    )

    kick = ctt.SpaceChargeKick(0.5, grid_shape=(64, 64, 64), dtype=torch.float32)
    before = (cic_kernels.deposit_multi_3d.launches, cic_kernels.gather_multi_3d.launches)
    out = kick.track(beam)
    torch.cuda.synchronize()
    after = (cic_kernels.deposit_multi_3d.launches, cic_kernels.gather_multi_3d.launches)
    check(
        (after[0] - before[0], after[1] - before[1]) == (1, 1),
        "the 64^3 kick did not launch each kernel once",
    )
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles after the 64^3 kick")
    kick_cpu = ctt.SpaceChargeKick(0.5, grid_shape=(64, 64, 64), dtype=torch.float64, device="cpu")
    errors = _check_kicks("64^3 kick", beam, out, kick_cpu.track(beam.to("cpu", torch.float64)))
    emit(
        "space_charge_kick_64",
        particles=NUM_PARTICLES, grid=[64, 64, 64], ms=time_ms(lambda: kick.track(beam), runs=10),
        kick_rms_rel_err_vs_cpu_f64=errors,
    )
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.ops import cic_kernels

    smi = phase_environment()
    phase_build(cic_kernels)
    numbers = phase_kernels(cic_kernels)
    phase_env_step(ctt, cic_kernels)
    deposit_launches, gather_launches = phase_space_charge(ctt, cic_kernels)

    source = "cheetah_tpu_torch/csrc/cic.cu"
    kernels = [
        {
            "name": "deposit_multi_3d",
            "route": "cuda",
            "source": source,
            "replaces": "cheetah_tpu/ops/pallas_cic.py:316",
            "launches": deposit_launches,
            **numbers["deposit"],
        },
        {
            "name": "gather_multi_3d",
            "route": "cuda",
            "source": source,
            "replaces": "cheetah_tpu/ops/pallas_cic.py:238",
            "launches": gather_launches,
            **numbers["gather"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
