"""The device time of cuFFT's kernels (the space-charge kick's Poisson
solve on the doubled grid), in milliseconds a step."""


def read(trace):
    ffts = [op for op in trace.kernels if "fft" in op.name.lower()]
    if not ffts:
        return None
    return sum(op.seconds for op in ffts) * 1e3 / trace.steps
