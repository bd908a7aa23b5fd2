"""The device time of the traced window's operations (kernels, copies and
fills, summed), in milliseconds a step."""


def read(trace):
    if not trace.device_ops:
        return None
    return sum(op.seconds for op in trace.device_ops) * 1e3 / trace.steps
