"""Drift section (counterpart of ``cheetah_tpu/accelerator/drift.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    dkd_outgoing,
    num_pieces,
    require_particle_beam,
)
from cheetah_tpu_torch.ops import fused_maps
from cheetah_tpu_torch.ops.transfer_maps import base_ttensor, drift_matrix, with_first_order
from cheetah_tpu_torch.particles import Beam, ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils import bmadx
from cheetah_tpu_torch.utils.names import merge_element_names


class Drift(Element):
    """Drift section in a particle accelerator.

    :param length: Length in m.
    :param tracking_method: One of ``"linear"``, ``"second_order"``,
        ``"drift_kick_drift"`` (the exact Bmad-X drift).
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["linear", "second_order", "drift_kick_drift"]
    fused_opcode = fused_maps.DRIFT

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

    def second_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        zero = torch.zeros_like(self.length)
        T = base_ttensor(self.length, k1=zero, k2=zero, hx=zero, species=species, energy=energy)
        return with_first_order(T, drift_matrix(self.length, energy, species))

    def _track_drift_kick_drift(self, incoming: Beam) -> ParticleBeam:
        """Exact nonlinear drift through the Bmad-X map."""
        incoming = require_particle_beam(incoming)
        mc2 = incoming.species.mass_eV
        z, pz, p0c = bmadx.cheetah_to_bmad_z_pz(incoming.tau, incoming.p, incoming.energy, mc2)
        x, y, z = bmadx.track_a_drift(
            self.length, incoming.x, incoming.px, incoming.y, incoming.py, z, pz, p0c, mc2
        )
        tau, delta, ref_energy = bmadx.bmad_to_cheetah_z_pz(z, pz, p0c, mc2)
        return dkd_outgoing(
            incoming, (x, incoming.px, y, incoming.py, tau, delta), ref_energy, self.length
        )

    @property
    def is_skippable(self) -> bool:
        return self.tracking_method == "linear"

    def split(self, resolution: torch.Tensor | float) -> list[Element]:
        count = num_pieces(self.length, resolution)
        return [
            Drift(
                self.length / count,
                tracking_method=self.tracking_method,
                name=f"{self.name}_split_{i}",
                sanitize_name=False,
                metadata=self.metadata,
            )
            for i in range(count)
        ]

    def merge(self, other: "Drift") -> "Drift | None":
        if self.tracking_method != other.tracking_method:
            return None
        return Drift(
            self.length + other.length,
            tracking_method=self.tracking_method,
            name=merge_element_names(self.name, other.name),
            sanitize_name=False,
            metadata={**other.metadata, **self.metadata},
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length"]
