"""Horizontal and vertical corrector magnets (counterpart of the H/V
correctors in ``cheetah_tpu/accelerator/correctors.py``).

A corrector is a drift with a thin kick applied through the affine (7th)
column of the transfer map.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.ops.transfer_maps import drift_matrix
from cheetah_tpu_torch.particles.species import Species


class _Corrector(Element):
    """Drift plus a thin kick of ``angle`` into the momentum at ``_kick_row``."""

    _kick_row: int

    def __init__(
        self,
        length: torch.Tensor | float,
        angle: torch.Tensor | float | None = None,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(
            ("length", length), dtype, device, angle=angle if angle is not None else 0.0
        )
        self._init_element(name, sanitize_name, metadata)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        tm = drift_matrix(self.length, energy, species)
        shape = torch.broadcast_shapes(tm.shape, (*self.angle.shape, 1, 1))
        tm = tm.expand(shape).clone()
        tm[..., self._kick_row, 6] = self.angle
        return tm

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "angle"]


class HorizontalCorrector(_Corrector):
    """Horizontal corrector magnet: drift plus thin horizontal kick.

    :param length: Length in m.
    :param angle: Kick angle in rad.
    """

    _kick_row = 1


class VerticalCorrector(_Corrector):
    """Vertical corrector magnet: drift plus thin vertical kick.

    :param length: Length in m.
    :param angle: Kick angle in rad.
    """

    _kick_row = 3
