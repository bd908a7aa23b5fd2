"""Beam position monitor (counterpart of ``cheetah_tpu/accelerator/bpm.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    ZeroLengthMixin,
    identity_transfer_map,
)
from cheetah_tpu_torch.particles import Beam
from cheetah_tpu_torch.particles.species import Species


class BPM(ZeroLengthMixin, Element):
    """Beam position monitor reading out the transverse beam centroid.

    The functional readout is :meth:`observe`; ``Segment.track_with_readings``
    collects it. Tracking an active BPM also keeps its latest reading as
    ``bpm.reading``.

    :param is_active: Whether the BPM records readings.
    :param misalignment: Misalignment ``(x, y)`` of the BPM in m.
    :param name: Unique identifier of the element.
    :param device: Device of the misalignment; the GPU when ``None``.
    """

    def __init__(
        self,
        is_active: bool = False,
        name: str | None = None,
        misalignment: torch.Tensor | tuple | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(
            ("misalignment", misalignment if misalignment is not None else (0.0, 0.0)),
            dtype,
            device,
        )
        self.is_active = is_active
        self._cached_reading = None
        self._init_element(name, sanitize_name, metadata)

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    @property
    def reading(self) -> torch.Tensor:
        """Latest reading, or NaNs if nothing has been recorded."""
        if self._cached_reading is None:
            return torch.full(
                (2,), float("nan"), dtype=self.misalignment.dtype,
                device=self.misalignment.device,
            )
        return self._cached_reading

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return identity_transfer_map(energy)

    def observe(self, incoming: Beam) -> torch.Tensor:
        """Misalignment-corrected beam centroid of shape ``(..., 2)``."""
        return torch.stack(
            torch.broadcast_tensors(
                incoming.mu_x - self.misalignment[..., 0],
                incoming.mu_y - self.misalignment[..., 1],
            ),
            dim=-1,
        )

    def _track(self, incoming: Beam) -> Beam:
        if self.is_active:
            self._cached_reading = self.observe(incoming)
        return incoming

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["is_active"]
