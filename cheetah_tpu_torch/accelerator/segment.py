"""Lattice segment (counterpart of ``cheetah_tpu/accelerator/segment.py``).

A ``Segment`` is an ``nn.Module`` holding an ordered ``nn.ModuleList`` of
elements. Its ``track`` partitions the lattice into runs of consecutive
*skippable* elements, composes each run's 7x7 transfer maps (cheap,
O(run * 7^3)) and applies the fused map to the beam once (O(N * 7^2)).
Elements are reachable as attributes by name.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.particles import ParticleBeam, Species


class Segment(Element):
    """Segment of a particle accelerator consisting of several elements.

    :param elements: Ordered list of elements describing the accelerator
        (section). Elements are also accessible as attributes by their name.
    :param name: Unique identifier of the segment.
    """

    def __init__(
        self,
        elements: list[Element],
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
    ) -> None:
        super().__init__()
        self.elements = nn.ModuleList(elements)
        self._init_element(name, sanitize_name, metadata)

    def __getattr__(self, name: str) -> Any:
        # nn.Module resolves parameters, buffers and submodules first; only
        # then are element names searched (duplicates return a list).
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("__"):
                raise
        elements = self.__dict__.get("_modules", {}).get("elements", ())
        matches = [element for element in elements if element.name == name]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            return matches
        raise AttributeError(f"'{type(self).__name__}' object has no attribute {name!r}")

    @property
    def element_names(self) -> list[str]:
        """Ordered list of the names of the elements in the segment."""
        return [element.name for element in self.elements]

    @property
    def is_skippable(self) -> bool:
        return all(element.is_skippable for element in self.elements)

    @property
    def length(self) -> torch.Tensor:
        lengths = [element.length for element in self.elements]
        total = lengths[0]
        for value in lengths[1:]:
            total = total + value
        return total

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor | None:
        if not self.is_skippable:
            return None
        tm = torch.eye(7, dtype=energy.dtype, device=energy.device)
        for element in self.elements:
            tm = element.first_order_transfer_map(energy, species) @ tm
        return tm

    def _track(self, incoming: ParticleBeam) -> ParticleBeam:
        """Consecutive skippable elements are fused into one composed
        transfer map applied with one matmul; the others track one by one."""
        if self.is_skippable:
            return self._track_first_order(incoming)
        for todo in self._plan():
            incoming = todo._track(incoming)
        return incoming

    def _plan(self) -> list[Element]:
        """Partition the elements into fused skippable runs and individual
        non-skippable elements."""
        todos: list[Element] = []
        run: list[Element] = []
        for element in self.elements:
            if element.is_skippable:
                run.append(element)
                continue
            if run:
                todos.append(Segment(run, sanitize_name=False))
                run = []
            todos.append(element)
        if run:
            todos.append(Segment(run, sanitize_name=False))
        return todos

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["elements"]

    def extra_repr(self) -> str:
        # The elements print as child modules.
        return f"name={self.name!r}"
