"""Rectangular bending magnet (counterpart of ``cheetah_tpu/accelerator/rbend.py``):
a :class:`Dipole` whose faces are given relative to the rectangular
geometry, ``dipole_e1 = rbend_e1 + angle / 2``."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.dipole import Dipole
from cheetah_tpu_torch.utils.device import as_float_tensor


class RBend(Dipole):
    """Rectangular bending magnet.

    ``rbend_e1`` and ``rbend_e2`` are views of the Dipole's ``dipole_e1``
    and ``dipole_e2`` buffers; assigning one replaces the buffer, so all
    three tracking methods see it.

    :param length: Length in m.
    :param angle: Deflection angle in rad.
    :param rbend_e1: Inclination of the entrance face in rad, relative to
        the rectangular geometry.
    :param rbend_e2: Inclination of the exit face in rad, relative to the
        rectangular geometry.

    All other parameters as for :class:`Dipole`.
    """

    def __init__(
        self,
        length: torch.Tensor | float,
        angle: torch.Tensor | float | None = None,
        k1: torch.Tensor | float | None = None,
        rbend_e1: torch.Tensor | float | None = None,
        rbend_e2: torch.Tensor | float | None = None,
        tilt: torch.Tensor | float | None = None,
        gap: torch.Tensor | float | None = None,
        gap_exit: torch.Tensor | float | None = None,
        fringe_integral: torch.Tensor | float | None = None,
        fringe_integral_exit: torch.Tensor | float | None = None,
        fringe_at: str = "both",
        fringe_type: str = "linear_edge",
        tracking_method: str = "linear",
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        length = as_float_tensor(length, dtype=dtype, device=device)

        def like_length(value):
            return as_float_tensor(
                value if value is not None else 0.0, dtype=length.dtype, device=length.device
            )

        angle = like_length(angle)
        super().__init__(
            length=length,
            angle=angle,
            k1=k1,
            dipole_e1=like_length(rbend_e1) + angle / 2,
            dipole_e2=like_length(rbend_e2) + angle / 2,
            tilt=tilt,
            gap=gap,
            gap_exit=gap_exit,
            fringe_integral=fringe_integral,
            fringe_integral_exit=fringe_integral_exit,
            fringe_at=fringe_at,
            fringe_type=fringe_type,
            tracking_method=tracking_method,
            name=name,
            sanitize_name=sanitize_name,
            metadata=metadata,
        )

    @property
    def rbend_e1(self) -> torch.Tensor:
        return self.dipole_e1 - self.angle / 2

    @rbend_e1.setter
    def rbend_e1(self, value: torch.Tensor | float) -> None:
        self.dipole_e1 = value + self.angle / 2

    @property
    def rbend_e2(self) -> torch.Tensor:
        return self.dipole_e2 - self.angle / 2

    @rbend_e2.setter
    def rbend_e2(self, value: torch.Tensor | float) -> None:
        self.dipole_e2 = value + self.angle / 2

    @property
    def defining_features(self) -> list[str]:
        features = super().defining_features
        features.remove("dipole_e1")
        features.remove("dipole_e2")
        return features + ["rbend_e1", "rbend_e2"]
