"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that use it) on synthetic traces, and the readers that were there
before them, which read the same whether or not the trace holds spans."""

import pytest

from portbench import harness, spans, trace as tracing
from portbench.trace import DeviceOp, Trace

MS = 1_000_000


def read(name, trace):
    return harness.metric_module(harness.BENCH_DIR, name).read(trace)


def _trace(with_spans: bool) -> Trace:
    """Two steps in 100 ms: four kernels, three launched while the host
    builds maps, one read of a device value."""
    host = [("cudaLaunchKernel", 15 * MS, 16 * MS), ("cudaLaunchKernel", 20 * MS, 21 * MS),
            ("cuLaunchKernel", 65 * MS, 66 * MS), ("cudaLaunchKernel", 80 * MS, 81 * MS),
            ("aten::_local_scalar_dense", 85 * MS, 86 * MS), ("aten::mul", 22 * MS, 23 * MS)]
    if with_spans:
        host += [("ctt.env.step", 0, 100 * MS), ("ctt.maps", 10 * MS, 40 * MS),
                 ("ctt.maps", 60 * MS, 70 * MS)]
    device = [DeviceOp("fft_kernel", 22 * MS, 30 * MS, "kernel"),
              DeviceOp("gemm", 50 * MS, 55 * MS, "kernel"),
              DeviceOp("elementwise", 67 * MS, 69 * MS, "kernel"),
              DeviceOp("Memcpy DtoH", 82 * MS, 90 * MS, "memcpy")]
    return Trace((0, 100 * MS), 2, device, host, {"plan_tiles": 0}, {"lattice": []}, {})


def test_maps_launches_and_idle_and_host_reads():
    trace = _trace(with_spans=True)
    assert read("maps_launches_per_step", trace) == 1.5
    # Idle in maps: 10-22, 30-40, 60-67 and 69-70 ms: 30 of 100 ms.
    assert abs(read("maps_idle_share", trace) - 30.0) < 1e-9
    assert read("maps_idle_share.grad", trace) == read("maps_idle_share", trace)
    assert read("host_reads_per_step", trace) == 0.5
    note = harness.metric_module(harness.BENCH_DIR, "maps_launches_per_step").note(trace)
    assert note["by_span"]["ctt.maps"] == {"launches": 1.5, "host_ms": 20.0, "idle_ms": 15.0}
    assert note["by_span"]["ctt.env.step"]["launches"] == 2.0


def test_nothing_to_read_without_spans_or_card():
    trace = _trace(with_spans=False)
    assert read("maps_launches_per_step", trace) is None
    assert read("maps_idle_share", trace) is None
    assert read("host_reads_per_step", trace) == 0.5
    no_card = Trace((0, 100 * MS), 2, [], _trace(True).host_ops, {}, {}, {})
    for name in ("maps_launches_per_step", "maps_idle_share", "host_reads_per_step"):
        assert read(name, no_card) is None


def test_earlier_readers_read_the_same_with_spans():
    """The device's readers and ``breakdown``'s device operations read the
    same on the trace with and without the program's spans; on the trace
    without, ``breakdown`` names the gaps after the host's operators."""
    plain, spanned = _trace(with_spans=False), _trace(with_spans=True)
    for name in ("device_idle_share", "device_busy_ms_per_step", "kernel_launches_per_step",
                 "fft_device_ms_per_step"):
        assert read(name, plain) == read(name, spanned), name
    assert read("kernel_launches_per_step", plain) == 1.5
    assert abs(read("device_idle_share", plain) - 77.0) < 1e-9
    assert read("device_busy_ms_per_step", plain) == 11.5
    assert read("fft_device_ms_per_step", plain) == 4.0
    assert tracing.breakdown(plain)["device_ops"] == tracing.breakdown(spanned)["device_ops"]
    # Every gap's midpoint falls between the host's operators: 77 ms.
    assert dict(tracing.breakdown(plain)["idle_gaps"]) == {"(no host op)": pytest.approx(0.077)}


def test_intervals_are_clipped_to_the_window_and_merged():
    trace = Trace((10, 100), 1, [], [("ctt.maps", 0, 20), ("ctt.maps", 15, 30),
                                     ("ctt.maps", 90, 120)], {}, {}, {})
    assert spans.intervals(trace, "ctt.maps") == [(10, 30), (90, 100)]
    assert spans.count_inside([5, 10, 29, 30, 95], [(10, 30), (90, 100)]) == 3
    assert spans.overlap_ns([(0, 15), (25, 95)], [(10, 30), (90, 100)]) == 15
