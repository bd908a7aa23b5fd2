"""Element-name utilities (ref ``cheetah/utils/names.py:4-38``)."""

from __future__ import annotations

import itertools


class UniqueNameGenerator:
    """Generates unique names with a fixed prefix: ``prefix_0``, ``prefix_1``, ..."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self._counter = itertools.count()

    def __call__(self) -> str:
        return f"{self.prefix}_{next(self._counter)}"


def merge_element_names(*names: str) -> str:
    """Merge element names into one for a merged element.

    If all names share a common prefix up to a trailing index, the merged name
    keeps the prefix and concatenates the indices; otherwise the names are
    joined with underscores.
    """
    if len(names) == 0:
        return "merged"
    split = [name.rsplit("_", 1) for name in names]
    prefixes = {s[0] for s in split if len(s) == 2}
    if len(prefixes) == 1 and all(len(s) == 2 for s in split):
        prefix = split[0][0]
        suffixes = "_".join(s[1] for s in split)
        return f"{prefix}_{suffixes}"
    return "_".join(names)


def sanitize_name(name: str) -> str:
    """Make ``name`` a valid Python identifier (ref ``element.py:360-373``)."""
    cleaned = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if cleaned and cleaned[0].isdigit():
        cleaned = "_" + cleaned
    return cleaned
