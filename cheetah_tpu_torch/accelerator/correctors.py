"""Corrector magnets (counterpart of ``cheetah_tpu/accelerator/correctors.py``).

A corrector is a drift with a thin kick applied through the affine (7th)
column of the transfer map: horizontal, vertical, or both at once.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element, any_nonzero
from cheetah_tpu_torch.ops import fused_maps
from cheetah_tpu_torch.ops.transfer_maps import corrector_matrix
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
        return corrector_matrix(self.length, energy, species, {self._kick_row: self.angle})

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.angle)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "angle"]


class HorizontalCorrector(_Corrector):
    """Horizontal corrector magnet: drift plus thin horizontal kick.

    :param length: Length in m.
    :param angle: Kick angle in rad.
    """

    _kick_row = 1
    fused_opcode = fused_maps.HORIZONTAL_CORRECTOR


class VerticalCorrector(_Corrector):
    """Vertical corrector magnet: drift plus thin vertical kick.

    :param length: Length in m.
    :param angle: Kick angle in rad.
    """

    _kick_row = 3
    fused_opcode = fused_maps.VERTICAL_CORRECTOR


class CombinedCorrector(Element):
    """Corrector magnet kicking in both planes: drift plus thin horizontal
    and vertical kicks.

    :param length: Length in m.
    :param horizontal_angle: Horizontal kick angle in rad.
    :param vertical_angle: Vertical kick angle in rad.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    fused_opcode = fused_maps.COMBINED_CORRECTOR

    def __init__(
        self,
        length: torch.Tensor | float,
        horizontal_angle: torch.Tensor | float | None = None,
        vertical_angle: torch.Tensor | float | None = None,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(
            ("length", length),
            dtype,
            device,
            horizontal_angle=horizontal_angle if horizontal_angle is not None else 0.0,
            vertical_angle=vertical_angle if vertical_angle is not None else 0.0,
        )
        self._init_element(name, sanitize_name, metadata)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return corrector_matrix(
            self.length, energy, species, {1: self.horizontal_angle, 3: self.vertical_angle}
        )

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.horizontal_angle) or any_nonzero(self.vertical_angle)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "horizontal_angle", "vertical_angle"]
