"""Superimposed elements (counterpart of ``cheetah_tpu/accelerator/superimposed.py``).

A zero-length element placed at the centre of a base element: the base is
tracked as two halves with the superimposed element between them.
"""

from __future__ import annotations

import copy

import torch

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.particles import Beam
from cheetah_tpu_torch.particles.species import Species


def _with_length(element: Element, length: torch.Tensor, name: str) -> Element:
    """A new module like ``element`` but with ``length`` and ``name``; every
    other buffer is the same tensor, so gradients reach ``element``'s
    parameters, and ``element`` itself is left unchanged."""
    half = copy.copy(element)
    for registry in ("_buffers", "_parameters", "_modules"):
        object.__setattr__(half, registry, getattr(element, registry).copy())
    half.length = length
    half.name = name
    return half


class Superimposed(Element):
    """One element superimposed at the centre of another.

    The two halves of the base element are new modules, built on every
    call from ``base_element``'s current buffers; ``base_element`` is never
    changed, and its parameters receive the gradients.

    :param base_element: The element at whose centre the superimposed
        element sits. It must have a ``length`` buffer.
    :param superimposed_element: Zero-length element placed at the centre.
    :param name: Unique identifier of the element.
    :param dtype: Accepted for the JAX package's signature; the two elements
        keep their own dtypes.
    :param device: Accepted likewise; the two elements keep their devices.
    """

    def __init__(
        self,
        base_element: Element,
        superimposed_element: Element,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        del dtype, device
        assert bool(
            torch.all(superimposed_element.length == 0.0)
        ), "The superimposed element must have zero length."
        assert (
            "length" in base_element._buffers
        ), "The base element must have a `length` buffer to be split in half."
        super().__init__()
        self.base_element = base_element
        self.superimposed_element = superimposed_element
        self._init_element(name, sanitize_name, metadata)

    def _segment(self):
        """The half-base / superimposed / half-base segment, built anew."""
        from cheetah_tpu_torch.accelerator.segment import Segment

        base = self.base_element
        half_length = base.length / 2.0
        return Segment(
            [
                _with_length(base, half_length, f"{base.name}_half_front"),
                self.superimposed_element,
                _with_length(base, half_length, f"{base.name}_half_back"),
            ],
            name=f"{self.name}_segment",
            sanitize_name=False,
        )

    def flattened(self):
        """The half-base / superimposed / half-base segment, flattened."""
        return self._segment().flattened()

    @property
    def is_skippable(self) -> bool:
        # Halving the length changes no element's skippability.
        return self.base_element.is_skippable and self.superimposed_element.is_skippable

    @property
    def length(self) -> torch.Tensor:
        return self.base_element.length

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return self._segment().first_order_transfer_map(energy, species)

    def _track(self, incoming: Beam) -> Beam:
        return self._segment()._track(incoming)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["base_element", "superimposed_element"]

    def extra_repr(self) -> str:
        # The two elements print as child modules.
        return f"name={self.name!r}"
