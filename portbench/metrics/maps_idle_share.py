"""The share of the traced window in which the card is idle while the host
is inside the program's ``ctt.maps`` spans (building transfer maps), in
percent. Nothing to read without a device operation (no card) or without
the span (a program that has none)."""

from portbench import spans


def read(trace):
    maps = spans.intervals(trace, "ctt.maps")
    if not trace.device_ops or not maps:
        return None
    return 100.0 * spans.overlap_ns(spans.idle(trace), maps) / 1e9 / trace.window_s
