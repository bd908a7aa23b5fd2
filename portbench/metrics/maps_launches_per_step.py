"""The kernels launched a step while the host builds transfer maps: the
runtime's launch calls inside the program's ``ctt.maps`` spans (element
maps, fused runs' compositions, T-tensors). Nothing to read without a
device operation (no card) or without the span (a program that has none).
The note gives each span's launches, host time and idle time a step
(:func:`portbench.spans.by_span`)."""

from portbench import spans


def read(trace):
    maps = spans.intervals(trace, "ctt.maps")
    if not trace.device_ops or not maps:
        return None
    return spans.count_inside(spans.launches(trace), maps) / trace.steps


def note(trace) -> dict:
    return {"by_span": spans.by_span(trace)}
