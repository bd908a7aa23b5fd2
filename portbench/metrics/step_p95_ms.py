"""``step_p95_ms`` by the host's clock, read per layer: the 95th percentile
of every step of the untraced window that a traced run measures first, in
milliseconds. Nothing to read where the run measured no such window."""


def read(trace):
    return None if trace.host is None else trace.host["step_p95_ms"]
