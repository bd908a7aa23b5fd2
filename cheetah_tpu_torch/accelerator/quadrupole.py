"""Quadrupole magnet (counterpart of ``cheetah_tpu/accelerator/quadrupole.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.ops.transfer_maps import (
    base_rmatrix,
    combined_rotation_misalignment_matrix,
)
from cheetah_tpu_torch.particles.species import Species


class Quadrupole(Element):
    """Quadrupole magnet in a particle accelerator.

    :param length: Length in m.
    :param k1: Strength of the quadrupole in 1/m^2.
    :param misalignment: Misalignment vector ``(dx, dy)`` in m.
    :param tilt: Tilt angle in the x-y plane in rad (``pi/4`` for a
        skew quadrupole).
    :param num_steps: Number of drift-kick-drift steps.
    :param tracking_method: ``"linear"``, ``"second_order"`` or
        ``"drift_kick_drift"``. Only ``"linear"`` is ported so far.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["linear", "second_order", "drift_kick_drift"]

    def __init__(
        self,
        length: torch.Tensor | float,
        k1: torch.Tensor | float | None = None,
        misalignment: torch.Tensor | tuple | None = None,
        tilt: torch.Tensor | float | None = None,
        num_steps: int = 1,
        tracking_method: str = "linear",
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
            k1=k1 if k1 is not None else 0.0,
            misalignment=misalignment if misalignment is not None else (0.0, 0.0),
            tilt=tilt if tilt is not None else 0.0,
        )
        self.num_steps = num_steps
        self._init_element(name, sanitize_name, metadata, tracking_method)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        R = base_rmatrix(
            length=self.length,
            k1=self.k1,
            hx=torch.zeros_like(self.length),
            species=species,
            energy=energy,
        )
        R_entry, R_exit = combined_rotation_misalignment_matrix(
            angle=self.tilt, misalignment=self.misalignment
        )
        return R_exit @ R @ R_entry

    @property
    def is_skippable(self) -> bool:
        return self.tracking_method == "linear"

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "length",
            "k1",
            "misalignment",
            "tilt",
            "num_steps",
        ]
