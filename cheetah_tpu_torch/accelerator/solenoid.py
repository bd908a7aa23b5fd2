"""Solenoid magnet (counterpart of ``cheetah_tpu/accelerator/solenoid.py``)."""

from __future__ import annotations

import math

import torch

from cheetah_tpu_torch.accelerator.element import Element, any_nonzero, num_pieces
from cheetah_tpu_torch.ops.transfer_maps import matrix7, misalignment_matrix
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.names import merge_element_names
from cheetah_tpu_torch.utils.physics import compute_relativistic_factors


class Solenoid(Element):
    """Solenoid magnet (A. W. Chao, p. 74): a coupled rotation-focusing 4x4
    block plus R56. Linear tracking only; asking for another method warns
    and keeps ``"linear"``.

    :param length: Length in m.
    :param k: Normalised strength ``B0 / (2 Brho)`` in 1/m.
    :param misalignment: Misalignment ``(dx, dy)`` in m.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    def __init__(
        self,
        length: torch.Tensor | float,
        k: torch.Tensor | float | None = None,
        misalignment: torch.Tensor | tuple | None = None,
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
            k=k if k is not None else 0.0,
            misalignment=misalignment if misalignment is not None else (0.0, 0.0),
        )
        self._init_element(name, sanitize_name, metadata)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        gamma, _, _ = compute_relativistic_factors(energy, species.mass_eV)
        length, k, gamma = torch.broadcast_tensors(self.length, self.k, gamma)
        c = torch.cos(length * k)
        s = torch.sin(length * k)
        # sin(k L) / k, finite with a zero gradient at k = 0.
        s_k = torch.sinc(length * k / math.pi) * length
        r56 = length / (1 - torch.square(gamma))

        R = matrix7(
            {
                (0, 0): c * c,
                (0, 1): c * s_k,
                (0, 2): s * c,
                (0, 3): s * s_k,
                (1, 0): -k * s * c,
                (1, 1): c * c,
                (1, 2): -k * s * s,
                (1, 3): s * c,
                (2, 0): -s * c,
                (2, 1): -s * s_k,
                (2, 2): c * c,
                (2, 3): c * s_k,
                (3, 0): k * s * s,
                (3, 1): -s * c,
                (3, 2): -k * s * c,
                (3, 3): c * c,
                (4, 5): r56,
            },
            length.shape,
            length,
        )
        R_entry, R_exit = misalignment_matrix(self.misalignment)
        return R_exit @ R @ R_entry

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.k)

    def split(self, resolution: torch.Tensor | float) -> list[Element]:
        count = num_pieces(self.length, resolution)
        return [
            Solenoid(
                length=self.length / count,
                k=self.k,
                misalignment=self.misalignment,
                name=f"{self.name}_split_{i}",
                sanitize_name=False,
                metadata=self.metadata,
            )
            for i in range(count)
        ]

    def merge(self, other: "Solenoid") -> "Solenoid | None":
        if not (
            self.misalignment.shape == other.misalignment.shape
            and bool(torch.all(self.misalignment == other.misalignment))
        ):
            return None
        return Solenoid(
            length=self.length + other.length,
            k=(self.k * self.length + other.k * other.length) / (self.length + other.length),
            misalignment=self.misalignment,
            name=merge_element_names(self.name, other.name),
            sanitize_name=False,
            metadata={**other.metadata, **self.metadata},
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "k", "misalignment"]
