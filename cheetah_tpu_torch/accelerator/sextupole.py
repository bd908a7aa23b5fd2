"""Sextupole magnet (counterpart of ``cheetah_tpu/accelerator/sextupole.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element, any_nonzero
from cheetah_tpu_torch.ops.transfer_maps import (
    base_ttensor,
    combined_rotation_misalignment_matrix,
    drift_matrix,
    with_first_order,
)
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.names import merge_element_names


class Sextupole(Element):
    """Sextupole magnet.

    To first order a sextupole is a drift; its field enters the second-order
    map alone, so the default tracking method is ``"second_order"``.

    :param length: Length in m.
    :param k2: Sextupole strength in 1/m^3.
    :param misalignment: Transverse misalignment ``(dx, dy)`` in m.
    :param tilt: Tilt angle in the x-y plane in rad.
    :param tracking_method: ``"linear"`` or ``"second_order"``.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["linear", "second_order"]

    def __init__(
        self,
        length: torch.Tensor | float,
        k2: torch.Tensor | float | None = None,
        misalignment: torch.Tensor | tuple | None = None,
        tilt: torch.Tensor | float | None = None,
        tracking_method: str = "second_order",
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
            k2=k2 if k2 is not None else 0.0,
            misalignment=misalignment if misalignment is not None else (0.0, 0.0),
            tilt=tilt if tilt is not None else 0.0,
        )
        self._init_element(name, sanitize_name, metadata, tracking_method)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return drift_matrix(self.length, energy, species)

    def second_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        zero = torch.zeros_like(self.length)
        T = base_ttensor(self.length, k1=zero, k2=self.k2, hx=zero, species=species, energy=energy)
        T = with_first_order(T, drift_matrix(self.length, energy, species))
        R_entry, R_exit = combined_rotation_misalignment_matrix(
            angle=self.tilt, misalignment=self.misalignment
        )
        return torch.einsum("...ij,...jkl,...kn,...lm->...inm", R_exit, T, R_entry, R_entry)

    @property
    def is_skippable(self) -> bool:
        return self.tracking_method == "linear"

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.k2)

    def merge(self, other: "Sextupole") -> "Sextupole | None":
        """The two as one sextupole, where their method, ``k2``,
        misalignment and tilt agree."""
        if not (
            self.tracking_method == other.tracking_method
            and self.k2.shape == other.k2.shape
            and bool(torch.all(self.k2 == other.k2))
            and bool(torch.all(self.misalignment == other.misalignment))
            and bool(torch.all(self.tilt == other.tilt))
        ):
            return None
        return Sextupole(
            self.length + other.length,
            k2=self.k2,
            misalignment=self.misalignment,
            tilt=self.tilt,
            tracking_method=self.tracking_method,
            name=merge_element_names(self.name, other.name),
            sanitize_name=False,
            metadata={**other.metadata, **self.metadata},
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "k2", "misalignment", "tilt"]
