"""The port's spans and counters (``cheetah_tpu_torch.utils.profiling``) on
the CPU.

A span with no sink on calls no profiler operator and is the shared
no-op. A ``torch.profiler`` profile and a ``recording()`` of a small
``BatchedLatticeEnv.step``, its ``grad_step``, its moments step and the
gradient of a space-charge line on 16^3 grids hold every span under its
expected parent, the same tree both ways; ``span_table`` puts the
backward's operators under ``<span>.backward`` by ``sequence_nr``. The
ARES subcell's steps read nothing on the host. ``span_table`` on synthetic
device events attributes kernels by correlation id and idle time by the
innermost span.
"""

from dataclasses import dataclass

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.accelerator.element import any_nonzero
from cheetah_tpu_torch.parallel import BatchedLatticeEnv
from cheetah_tpu_torch.utils import profiling

CPU = "cpu"
F64 = torch.float64
TUNABLES = [("AREAMQZM1", "k1"), ("AREAMQZM2", "k1"), ("AREAMCVM1", "angle"),
            ("AREAMQZM3", "k1"), ("AREAMCHM1", "angle")]

#: ``(span, parent)`` of an env step on the ARES subcell: the stretch to
#: the end is one fused run, tracked as a nested segment.
STEP_TREE = {
    ("ctt.env.step", None),
    ("ctt.segment.track", "ctt.env.step"),
    ("ctt.segment.track", "ctt.segment.track"),
    ("ctt.maps", "ctt.segment.track"),
    ("ctt.transport", "ctt.segment.track"),
    ("ctt.env.readout", "ctt.env.step"),
}
GRAD_STEP_TREE = (STEP_TREE - {("ctt.env.step", None)}) | {
    ("ctt.env.grad_step", None),
    ("ctt.env.step", "ctt.env.grad_step"),
}
MOMENTS_STEP_TREE = STEP_TREE | {("ctt.plan", "ctt.segment.track")}
SC_TREE = {
    ("ctt.segment.track", None),
    ("ctt.plan", "ctt.segment.track"),
    ("ctt.segment.track", "ctt.segment.track"),
    ("ctt.maps", "ctt.segment.track"),
    ("ctt.transport", "ctt.segment.track"),
    ("ctt.sc.kick", "ctt.segment.track"),
    *((f"ctt.sc.{child}", "ctt.sc.kick")
      for child in ("grid", "deposit", "green_function", "fft", "fields", "gather")),
}


def _env(moments_only=False):
    generator = torch.Generator().manual_seed(3)
    beam = ctt.ParticleBeam.from_twiss(
        num_particles=200, beta_x=5.0, emittance_x=2e-9, beta_y=5.0, emittance_y=2e-9,
        energy=1e8, dtype=F64, device=CPU, generator=generator,
    )
    if moments_only:
        beam = beam.as_parameter_beam()
    segment = ctt.lattices.ares_ea_subcell(F64, device=CPU)
    env = BatchedLatticeEnv(segment, beam, TUNABLES, moments_only=moments_only)
    settings = torch.rand(8, len(TUNABLES), dtype=F64, generator=generator)
    return env, settings


def _sc_gradient():
    """The gradient of ``sum(px^2)`` after a two-kick space-charge line on
    16^3 grids by its first drift's length."""
    beam, segment = ctt.lattices.cold_beam_line(
        kicks=2, grid_shape=(16, 16, 16), num_particles=2000, dtype=F64, device=CPU,
        generator=torch.Generator().manual_seed(0),
    )
    length = segment.elements[0].length.clone().requires_grad_()
    segment.elements[0].length = length

    def run():
        objective = torch.sum(torch.square(segment.track(beam).px))
        return torch.autograd.grad(objective, length)

    return run


def _tree(spans) -> set:
    return {(name, spans[parent][0] if parent >= 0 else None) for name, parent, _, _ in spans}


def _profiled(run):
    with profile(activities=[ProfilerActivity.CPU]) as profiled:
        run()
    return profiled


def _env_runs():
    env, settings = _env()
    moments_env, _ = _env(moments_only=True)
    return {
        "step": (lambda: env.step(settings), STEP_TREE),
        "grad_step": (lambda: env.grad_step(settings, 1.0), GRAD_STEP_TREE),
        "moments_step": (lambda: moments_env.step(settings), MOMENTS_STEP_TREE),
    }


# ----------------------------------------------------------------------
# No sink
# ----------------------------------------------------------------------


def test_span_with_no_sink_calls_no_profiler_operator(monkeypatch):
    """Every span of an env step and its gradient step runs with the
    profiler's range operator patched to raise; under a profile the same
    span calls it."""

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler operator was called")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    assert profiling.span("ctt.maps") is profiling._NO_SPAN
    env, settings = _env()
    env.step(settings)
    env.grad_step(settings, 1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("ctt.maps") is not profiling._NO_SPAN
        with pytest.raises(AssertionError, match="profiler operator"):
            with profiling.span("ctt.maps"):
                pass
    assert profiling.span("ctt.maps") is profiling._NO_SPAN


def test_compiled_code_records_no_span():
    """Under ``torch.compile`` a span is the no-op: a recording around the
    compiled call's tracing and run holds nothing, and the value is the
    eager one."""
    segment = ctt.Segment([ctt.Drift(0.5, dtype=F64, device=CPU),
                           ctt.Quadrupole(0.2, k1=3.0, dtype=F64, device=CPU)])
    beam = ctt.ParticleBeam.from_parameters(num_particles=50, energy=1e8, dtype=F64, device=CPU,
                                            generator=torch.Generator().manual_seed(1))
    compiled = torch.compile(lambda s, b: s.track(b).sigma_x, fullgraph=True, backend="eager")
    with profiling.recording() as recorded:
        value = compiled(segment, beam)
    assert recorded.spans == []
    assert torch.equal(value, segment.track(beam).sigma_x)


# ----------------------------------------------------------------------
# Span trees
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["step", "grad_step", "moments_step"])
def test_env_spans_nest_under_their_parents(name):
    run, tree = _env_runs()[name]
    run()
    assert _tree(profiling.profiled_spans(_profiled(run))) == tree


def test_space_charge_spans_nest_under_their_parents():
    assert _tree(profiling.profiled_spans(_profiled(_sc_gradient()))) == SC_TREE


@pytest.mark.parametrize("name", ["step", "grad_step", "moments_step", "sc_gradient"])
def test_recording_gives_the_profiles_tree(name):
    """The same spans in the same order with the same parents, on the
    host's clock, each inside its parent."""
    run = _sc_gradient() if name == "sc_gradient" else _env_runs()[name][0]
    run()
    profiled = profiling.profiled_spans(_profiled(run))
    with profiling.recording() as recorded:
        run()
    assert [(n, p) for n, p, _, _ in recorded.spans] == [(n, p) for n, p, _, _ in profiled]
    for name_, parent, start, end in recorded.spans:
        assert start <= end
        if parent >= 0:
            assert recorded.spans[parent][2] <= start and end <= recorded.spans[parent][3]


@pytest.mark.parametrize("name, expected", [
    ("grad_step", ("ctt.maps.backward", "ctt.transport.backward", "ctt.env.readout.backward")),
    ("sc_gradient", tuple(f"ctt.sc.{child}.backward" for child in
                          ("grid", "deposit", "green_function", "fft", "fields", "gather"))
     + ("ctt.maps.backward", "ctt.transport.backward")),
])
def test_backward_operators_count_under_their_forward_span(name, expected):
    """The autograd engine's operators count under ``<span>.backward`` of
    the span that ran the forward operation; inside the gradient step every
    operator has a span."""
    run = _sc_gradient() if name == "sc_gradient" else _env_runs()[name][0]
    run()
    table = profiling.span_table(_profiled(run))
    for label in expected:
        assert table[label]["host_ops"] > 0, label
    if name == "grad_step":
        assert table[profiling.UNATTRIBUTED]["host_ops"] == 0


def test_recording_summary_counts_a_nested_span_once():
    recorded = profiling.Recording()
    recorded.spans = [("ctt.segment.track", -1, 0, 100), ("ctt.segment.track", 0, 10, 60),
                      ("ctt.maps", 1, 20, 30), ("ctt.segment.track", -1, 200, 250)]
    assert recorded.summary() == {
        "ctt.segment.track": {"count": 3, "ms": pytest.approx(150 / 1e6)},
        "ctt.maps": {"count": 1, "ms": pytest.approx(10 / 1e6)},
    }


def test_recordings_do_not_nest():
    with profiling.recording():
        with pytest.raises(RuntimeError, match="open already"):
            with profiling.recording():
                pass


# ----------------------------------------------------------------------
# Counters
# ----------------------------------------------------------------------


def test_steps_read_nothing_on_the_host():
    """``host_reads`` stays put over the ARES subcell's env step, gradient
    step and moments step, and counts a read where one is made."""
    runs = _env_runs()
    for run, _ in runs.values():
        run()
    before = profiling.counters()
    for run, _ in runs.values():
        run()
    assert profiling.counters().get("host_reads", 0) == before.get("host_reads", 0)
    assert any_nonzero(torch.ones(2)) is True
    assert profiling.counters()["host_reads"] == before.get("host_reads", 0) + 1


def test_counters_are_a_snapshot():
    before = profiling.counters()
    profiling.count("test_counter", 3)
    assert before.get("test_counter", 0) + 3 == profiling.counters()["test_counter"]
    snapshot = profiling.counters()
    snapshot["test_counter"] = -1
    assert profiling.counters()["test_counter"] != -1


# ----------------------------------------------------------------------
# span_table on synthetic device events
# ----------------------------------------------------------------------

MS = 1_000_000


@dataclass
class _Event:
    _name: str
    _start: int
    _end: int
    _annotation: bool = False
    _device: bool = False
    _correlation: int = 0
    _sequence: int = -1
    _thread: int = 1
    _fwd_thread: int = 0

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def is_user_annotation(self):
        return self._annotation

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._correlation

    def sequence_nr(self):
        return self._sequence

    def start_thread_id(self):
        return self._thread

    def fwd_thread_id(self):
        return self._fwd_thread


class _Profile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def test_span_table_attributes_device_work_by_correlation_and_sequence():
    """A kernel launched under ``ctt.maps``, one under ``ctt.transport``, a
    copy launched under no span, and a kernel the autograd engine launches
    on its own thread for an operator that ``ctt.maps`` ran forward; the
    card's idle time goes to the span innermost on the host."""
    events = [
        _Event("ctt.env.step", 0, 100 * MS, _annotation=True),
        _Event("ctt.maps", 10 * MS, 40 * MS, _annotation=True),
        _Event("ctt.transport", 40 * MS, 60 * MS, _annotation=True),
        _Event("aten::mul", 20 * MS, 21 * MS, _sequence=5),
        _Event("cudaLaunchKernel", 15 * MS, 16 * MS, _correlation=101),
        _Event("cudaLaunchKernel", 45 * MS, 46 * MS, _correlation=102),
        _Event("cudaMemcpyAsync", 120 * MS, 121 * MS, _correlation=103),
        _Event("autograd::engine::evaluate_function: MulBackward0", 70 * MS, 80 * MS,
               _sequence=5, _thread=2, _fwd_thread=1),
        _Event("cudaLaunchKernel", 75 * MS, 76 * MS, _correlation=104,
               _thread=2),
        # Device events; a copy of the host's span on the card is no work.
        _Event("kernel_a", 20 * MS, 30 * MS, _device=True, _correlation=101),
        _Event("kernel_b", 50 * MS, 55 * MS, _device=True, _correlation=102),
        _Event("Memcpy DtoH", 125 * MS, 130 * MS, _device=True, _correlation=103),
        _Event("kernel_c", 76 * MS, 90 * MS, _device=True, _correlation=104),
        _Event("ctt.maps", 20 * MS, 30 * MS, _annotation=True, _device=True),
    ]
    table = profiling.span_table(_Profile(events), steps=2)
    assert table == {
        "ctt.env.step": {"device_ms": 0.0, "launches": 0.0, "idle_ms": 15.0, "host_ops": 0.0},
        "ctt.maps": {"device_ms": 5.0, "launches": 0.5, "idle_ms": 10.0, "host_ops": 0.5},
        "ctt.maps.backward": {"device_ms": 7.0, "launches": 0.5, "idle_ms": 3.0,
                              "host_ops": 0.0},
        "ctt.transport": {"device_ms": 2.5, "launches": 0.5, "idle_ms": 7.5, "host_ops": 0.0},
        profiling.UNATTRIBUTED: {"device_ms": 2.5, "launches": 0.0, "idle_ms": 0.0,
                                 "host_ops": 0.0},
    }


def test_span_table_is_empty_without_spans():
    events = [_Event("cudaLaunchKernel", 0, MS, _correlation=1),
              _Event("kernel_a", MS, 2 * MS, _device=True, _correlation=1)]
    assert profiling.span_table(_Profile(events)) == {}
