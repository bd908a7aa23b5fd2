"""The share of the traced window in which no operation ran on the card:
one minus the union of the device operations' intervals over the window's
length, in percent. Nothing to read where the trace holds no device
operation (no card)."""


def read(trace):
    if not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
