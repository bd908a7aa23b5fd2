"""Undulator (counterpart of ``cheetah_tpu/accelerator/undulator.py``): a
paraxial model with a longitudinal chirp and one focusing channel per
transverse plane."""

from __future__ import annotations

import math

import torch

from cheetah_tpu_torch.accelerator.element import Element, any_nonzero
from cheetah_tpu_torch.ops.transfer_maps import matrix7
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.physics import compute_relativistic_factors


class Undulator(Element):
    """Undulator element. Linear tracking only.

    The vertical field component (``kx``) focuses in y and the horizontal
    component (``ky``) focuses in x.

    :param length: Length in m.
    :param period: Undulator period in m.
    :param kx: Horizontal undulator strength parameter.
    :param ky: Vertical undulator strength parameter.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    def __init__(
        self,
        length: torch.Tensor | float,
        period: torch.Tensor | float | None = None,
        kx: torch.Tensor | float | None = None,
        ky: torch.Tensor | float | None = None,
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
            period=period if period is not None else 1.0,
            kx=kx if kx is not None else 0.0,
            ky=ky if ky is not None else 0.0,
        )
        self._init_element(name, sanitize_name, metadata)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        gamma, igamma2, beta = compute_relativistic_factors(energy, species.mass_eV)
        length, igamma2, beta, gamma, kx, ky, period = torch.broadcast_tensors(
            self.length, igamma2, beta, gamma, self.kx, self.ky, self.period
        )
        r56 = (
            -length
            * igamma2
            * (1.0 / torch.square(beta) + 0.5 * (torch.square(kx) + torch.square(ky)))
        )

        period_safe = torch.where(period > 0.0, period, torch.ones_like(period))
        spatial_frequency = torch.where(
            period > 0.0,
            math.sqrt(2.0) * math.pi / (period_safe * gamma * beta),
            torch.zeros_like(period),
        )
        # Focusing from the vertical field (kx) acts in y, from the
        # horizontal field (ky) in x.
        omega_x = spatial_frequency * kx
        omega_y = spatial_frequency * ky

        def channel(omega: torch.Tensor) -> tuple[torch.Tensor, ...]:
            phase = omega * length
            cos = torch.cos(phase)
            return cos, torch.sinc(phase / math.pi) * length, -torch.sin(phase) * omega, cos

        y00, y01, y10, y11 = channel(omega_x)
        x00, x01, x10, x11 = channel(omega_y)
        return matrix7(
            {
                (0, 0): x00,
                (0, 1): x01,
                (1, 0): x10,
                (1, 1): x11,
                (2, 2): y00,
                (2, 3): y01,
                (3, 2): y10,
                (3, 3): y11,
                (4, 5): r56,
            },
            length.shape,
            length,
        )

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.kx) or any_nonzero(self.ky)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "period", "kx", "ky"]
