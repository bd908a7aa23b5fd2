"""Partial-broadcast index arithmetic (a copy of ``cheetah_tpu/utils/vector.py``,
which is plain Python)."""

from __future__ import annotations


def squash_index_for_unavailable_dims(index: tuple, shape: tuple) -> tuple:
    """Squash an index meant for the fully broadcast vector shape so it works
    on a result that was only affected by part of the vectorisations.

    Example: vector shapes ``(3,)`` and ``(2, 1)`` broadcast to ``(2, 3)``.
    The index ``(1, 2)`` squashes to ``(1, 0)`` for a ``(2, 1)``-shaped result
    and to ``(2,)`` for a ``(3,)``-shaped one.
    """
    if index is None:
        return None
    trimmed = index[-len(shape):]
    return tuple(0 if s == 1 else i for i, s in zip(trimmed, shape))
