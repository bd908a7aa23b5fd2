"""Published peaks of one NVIDIA H100 SXM (NVIDIA data sheet, at its 700 W
limit) and the least time a piece of work needs on it."""

from __future__ import annotations

#: HBM bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Float32 operations per second outside the tensor cores.
F32_OPS_PER_S = 67e12


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    """Least time on the card in seconds, and what sets it (``"bytes"`` or
    ``"operations"``)."""
    byte_s = bytes_moved / HBM_BYTES_PER_S
    op_s = operations / F32_OPS_PER_S
    return (byte_s, "bytes") if byte_s >= op_s else (op_s, "operations")
