"""``step_ms`` by the host's clock, read per layer: the untraced window that
a traced run measures first, over the steps it completed, in milliseconds.
Nothing to read where the run measured no such window."""


def read(trace):
    return None if trace.host is None else trace.host["step_ms"]
