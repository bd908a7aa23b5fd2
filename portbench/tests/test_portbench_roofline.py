"""The CIC roofline's work, counted by hand at 128^3 cells and 1M
particles (float32: 4 bytes a value)."""

from portbench import harness, peaks
from portbench.trace import DeviceOp, Trace

CELLS = 128**3  # 2,097,152
N = 1_000_000

module = vars(harness.metric_module(harness.BENCH_DIR, "cic_roofline_share"))
read = module["read"]


def test_deposit_bytes():
    # Positions (3) and one charge read a particle, one grid written.
    assert module["deposit_work"](N, CELLS, 1, 1) == (4 * (4 * N + CELLS), 40 * N)
    assert module["deposit_work"](N, CELLS, 1, 1)[0] == 24_388_608


def test_gather_bytes():
    # Three force grids and the positions read, three values written.
    assert module["gather_work"](N, CELLS, 1, 3) == (4 * (3 * CELLS + 6 * N), 96 * N)
    assert module["gather_work"](N, CELLS, 1, 3)[0] == 49_165_824


def test_plan_bytes():
    # Positions read; permutation (8), tile (4), sorted positions (12) written.
    assert module["plan_work"](N) == (36_000_000, 4_000_000)


def test_step_is_bytes_bound_and_share_is_least_time_over_cic_time():
    config = {"lattice": [{"type": "SpaceChargeKick", "grid_shape": [128, 128, 128]}] * 2,
              "beam": {"num_particles": N}}
    trace = Trace((0, 10**9), 2, [DeviceOp("void deposit_tiled_kernel<float, 1>(x)", 0,
                                           2 * 10**6, "kernel")],
                  [], {"plan_tiles": 8}, config, {"entry": "track_grad"})
    least, by = module["least_seconds"](trace)
    assert by == "bytes"
    calls = module["step_calls"](N, CELLS, 2, True)
    assert len(calls) == 10
    expected = sum(peaks.bound(b, o)[0] for _, b, o in calls) + 4 * 36_000_000 / peaks.HBM_BYTES_PER_S
    assert abs(least - expected) < 1e-15
    # 1 ms of CIC kernels a step.
    assert abs(read(trace) - 100 * least / 1e-3) < 1e-9
    assert module["note"](trace) == {"least_ms_per_step": least * 1e3, "bound_by": "bytes"}


def test_nothing_to_read_without_cic_kernels():
    config = {"lattice": [{"type": "Drift"}], "beam": {"num_particles": N}}
    trace = Trace((0, 10**9), 1, [DeviceOp("gemm", 0, 10, "kernel")], [], {}, config, {})
    assert read(trace) is None
