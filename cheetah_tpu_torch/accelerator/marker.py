"""Marker element (counterpart of ``cheetah_tpu/accelerator/marker.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.particles import ParticleBeam
from cheetah_tpu_torch.particles.species import Species


class Marker(Element):
    """Zero-length identity element marking a position in the lattice.

    :param name: Unique identifier of the element.
    :param device: Device of its zero length; the GPU when ``None``.
    """

    def __init__(
        self,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(("length", 0.0), dtype, device)
        self._init_element(name, sanitize_name, metadata)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        eye = torch.eye(7, dtype=energy.dtype, device=energy.device)
        return eye.expand(*energy.shape, 7, 7)

    def _track(self, incoming: ParticleBeam) -> ParticleBeam:
        return incoming

    @property
    def is_skippable(self) -> bool:
        return True
