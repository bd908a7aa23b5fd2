"""The kernels the profiler recorded on the card in the traced window, a
step: the host's dispatch of map building, transport, readout and, where
the cell has them, the collective effect's kernels."""


def read(trace):
    kernels = trace.kernels
    if not kernels:
        return None
    return len(kernels) / trace.steps
