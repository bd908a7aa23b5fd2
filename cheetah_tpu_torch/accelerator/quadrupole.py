"""Quadrupole magnet (counterpart of ``cheetah_tpu/accelerator/quadrupole.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    any_nonzero,
    dkd_outgoing,
    host_bool,
    num_pieces,
    require_particle_beam,
)
from cheetah_tpu_torch.ops import fused_maps
from cheetah_tpu_torch.ops.transfer_maps import (
    base_rmatrix,
    base_ttensor,
    combined_rotation_misalignment_matrix,
    quadrupole_matrix,
    with_first_order,
)
from cheetah_tpu_torch.particles import Beam, ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils import bmadx
from cheetah_tpu_torch.utils.names import merge_element_names


class Quadrupole(Element):
    """Quadrupole magnet in a particle accelerator.

    :param length: Length in m.
    :param k1: Strength of the quadrupole in 1/m^2.
    :param misalignment: Misalignment vector ``(dx, dy)`` in m.
    :param tilt: Tilt angle in the x-y plane in rad (``pi/4`` for a
        skew quadrupole).
    :param num_steps: Number of drift-kick-drift steps; the closed form
        that tracks them does not depend on it.
    :param tracking_method: ``"linear"``, ``"second_order"`` or
        ``"drift_kick_drift"``.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["linear", "second_order", "drift_kick_drift"]
    fused_opcode = fused_maps.QUADRUPOLE

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
        return quadrupole_matrix(
            self.length, self.k1, self.misalignment, self.tilt, energy, species
        )

    def second_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        zero = torch.zeros_like(self.length)
        T = base_ttensor(
            self.length, k1=self.k1, k2=zero, hx=zero, species=species, energy=energy
        )
        R = base_rmatrix(self.length, k1=self.k1, hx=zero, species=species, energy=energy)
        T = with_first_order(T, R)
        # Misalignment and rotation around the whole second-order map.
        R_entry, R_exit = combined_rotation_misalignment_matrix(
            angle=self.tilt, misalignment=self.misalignment
        )
        return torch.einsum("...ij,...jkl,...kn,...lm->...inm", R_exit, T, R_entry, R_entry)

    def _track_drift_kick_drift(self, incoming: Beam) -> ParticleBeam:
        """Momentum-dependent drift-kick-drift tracking with the Bmad-X
        quadrupole coefficients, in closed form instead of ``num_steps``
        steps (``cheetah_tpu/accelerator/quadrupole.py:110-206``): ``pz`` is
        constant through the element, so the steps' 2x2 maps compose to the
        full length's (``A(L/n)^n = A(L)``), their z quadratic forms
        telescope to the full length's, and ``low_energy_z_correction`` is
        linear in the step length. The chromatic factorisation leaves one
        ``sqrt`` per particle
        (:func:`~cheetah_tpu_torch.utils.bmadx.calculate_quadrupole_coefficients_chromatic`).
        The misalignment and tilt frames are always applied: at zero they
        are the identity, bit for bit.
        """
        incoming = require_particle_beam(incoming)
        mc2 = incoming.species.mass_eV
        z, pz, p0c = bmadx.cheetah_to_bmad_z_pz(incoming.tau, incoming.p, incoming.energy, mc2)
        x_offset, y_offset = self.misalignment[..., 0], self.misalignment[..., 1]
        x, px, y, py = bmadx.offset_particle_set(
            x_offset, y_offset, self.tilt, incoming.x, incoming.px, incoming.y, incoming.py
        )

        (tx, dzx), (ty, dzy) = bmadx.calculate_quadrupole_coefficients_chromatic(
            self.k1[..., None], self.length, pz
        )
        dz_low_energy = bmadx.low_energy_z_correction(pz, p0c, mc2, self.length)
        z = (
            z
            + dzx[0] * torch.square(x)
            + dzx[1] * x * px
            + dzx[2] * torch.square(px)
            + dzy[0] * torch.square(y)
            + dzy[1] * y * py
            + dzy[2] * torch.square(py)
            + dz_low_energy
        )
        x, px = tx[0][0] * x + tx[0][1] * px, tx[1][0] * x + tx[1][1] * px
        y, py = ty[0][0] * y + ty[0][1] * py, ty[1][0] * y + ty[1][1] * py

        x, px, y, py = bmadx.offset_particle_unset(x_offset, y_offset, self.tilt, x, px, y, py)
        tau, delta, ref_energy = bmadx.bmad_to_cheetah_z_pz(z, pz, p0c, mc2)
        return dkd_outgoing(incoming, (x, px, y, py, tau, delta), ref_energy, self.length)

    @property
    def is_skippable(self) -> bool:
        return self.tracking_method == "linear"

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.k1)

    def split(self, resolution: torch.Tensor | float) -> list[Element]:
        count = num_pieces(self.length, resolution)
        return [
            Quadrupole(
                self.length / count,
                self.k1,
                misalignment=self.misalignment,
                tilt=self.tilt,
                num_steps=self.num_steps,
                tracking_method=self.tracking_method,
                name=f"{self.name}_split_{i}",
                sanitize_name=False,
                metadata=self.metadata,
            )
            for i in range(count)
        ]

    def merge(self, other: "Quadrupole") -> "Quadrupole | None":
        """The two as one quadrupole of length-weighted ``k1`` and summed
        ``num_steps``, where their method, misalignment and tilt agree."""
        if not (
            self.tracking_method == other.tracking_method
            and self.misalignment.shape == other.misalignment.shape
            and host_bool(torch.all(self.misalignment == other.misalignment))
            and host_bool(torch.all(self.tilt == other.tilt))
        ):
            return None
        return Quadrupole(
            self.length + other.length,
            k1=(self.k1 * self.length + other.k1 * other.length)
            / (self.length + other.length),
            misalignment=self.misalignment,
            tilt=self.tilt,
            num_steps=self.num_steps + other.num_steps,
            tracking_method=self.tracking_method,
            name=merge_element_names(self.name, other.name),
            sanitize_name=False,
            metadata={**other.metadata, **self.metadata},
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "length",
            "k1",
            "misalignment",
            "tilt",
            "num_steps",
        ]
