"""Drift section (counterpart of ``cheetah_tpu/accelerator/drift.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.ops.transfer_maps import drift_matrix
from cheetah_tpu_torch.particles.species import Species


class Drift(Element):
    """Drift section in a particle accelerator.

    :param length: Length in m.
    :param tracking_method: One of ``"linear"``, ``"second_order"``,
        ``"drift_kick_drift"``. Only ``"linear"`` is ported so far; the
        others raise ``NotImplementedError`` when tracking.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["linear", "second_order", "drift_kick_drift"]

    def __init__(
        self,
        length: torch.Tensor | float,
        tracking_method: str = "linear",
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(("length", length), dtype, device)
        self._init_element(name, sanitize_name, metadata, tracking_method)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return drift_matrix(length=self.length, energy=energy, species=species)

    @property
    def is_skippable(self) -> bool:
        return self.tracking_method == "linear"

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length"]
