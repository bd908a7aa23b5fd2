"""SI-prefixed axis formatting helpers (a copy of ``cheetah_tpu/utils/plot.py``,
which works on numpy data; the plots pass it host arrays)."""

from __future__ import annotations

import matplotlib.ticker
import numpy as np


class NoSymbolPercentFormatter(matplotlib.ticker.FuncFormatter):
    """Formatter for percentages without the percent symbol."""

    def __init__(self):
        super().__init__(lambda x, _: f"{x * 100:.1f}")


class IdentityFormatter(matplotlib.ticker.FuncFormatter):
    """Formatter for base values."""

    def __init__(self):
        super().__init__(lambda x, _: f"{x:.0f}")


class MilliFormatter(matplotlib.ticker.FuncFormatter):
    """Formatter for milli values."""

    def __init__(self):
        super().__init__(lambda x, _: f"{x * 1e3:.0f}")


class MicroFormatter(matplotlib.ticker.FuncFormatter):
    """Formatter for micro values."""

    def __init__(self):
        super().__init__(lambda x, _: f"{x * 1e6:.0f}")


def determine_prefixed_unit_and_tick_formatter(
    base_unit: str, data
) -> tuple[str, matplotlib.ticker.FuncFormatter]:
    """Pick the SI prefix and tick formatter best matching the data's order of
    magnitude."""
    magnitude = np.max(np.abs(np.asarray(data)))
    if 1.0 <= magnitude < 1e3:
        return base_unit, IdentityFormatter()
    elif 1e-3 <= magnitude < 1.0:
        return f"m{base_unit}", MilliFormatter()
    elif 1e-6 <= magnitude < 1e-3:
        return f"μ{base_unit}", MicroFormatter()
    else:
        return base_unit, IdentityFormatter()


def format_axis_with_prefixed_unit(axis, base_unit: str, data) -> None:
    """Add a prefixed unit to the axis label and set tick formatters."""
    prefixed_unit, tick_formatter = determine_prefixed_unit_and_tick_formatter(
        base_unit, data
    )
    axis.set_label_text(f"{axis.get_label_text()} ({prefixed_unit})")
    axis.set_major_formatter(tick_formatter)
    axis.set_minor_formatter(tick_formatter)


def format_axis_as_percentage(axis) -> None:
    """Add a percentage label and formatter to the axis."""
    axis.set_label_text(f"{axis.get_label_text()} (%)")
    axis.set_major_formatter(NoSymbolPercentFormatter())
    axis.set_minor_formatter(NoSymbolPercentFormatter())
