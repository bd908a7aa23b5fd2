"""The host's reads of device values a step: the traced window's
``aten::_local_scalar_dense`` operators (``.item()``, ``bool(...)``,
``int(...)`` of a device tensor), each of which waits for the stream to
drain. Nothing to read without a device operation (no card)."""

from portbench import spans


def read(trace):
    if not trace.device_ops:
        return None
    start, end = trace.window_ns
    reads = [op for op, lo, _ in trace.host_ops if op == spans.SCALAR_READ and start <= lo < end]
    return len(reads) / trace.steps
