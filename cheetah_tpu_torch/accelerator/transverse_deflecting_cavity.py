"""Transverse deflecting cavity (counterpart of
``cheetah_tpu/accelerator/transverse_deflecting_cavity.py``)."""

from __future__ import annotations

import math

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    any_nonzero,
    dkd_outgoing,
    require_particle_beam,
)
from cheetah_tpu_torch.constants import speed_of_light
from cheetah_tpu_torch.particles import Beam, ParticleBeam
from cheetah_tpu_torch.utils import bmadx


class TransverseDeflectingCavity(Element):
    """Transverse deflecting cavity: half drift, transverse RF kick with the
    energy modulation ``E += V cos(phase) k x``, half drift (the Bmad-X
    crab-cavity map). Drift-kick-drift tracking only, of a
    :class:`ParticleBeam`.

    The misalignment and tilt frames are always applied: at zero they are
    the identity, bit for bit, and the outgoing beam's vector shape is the
    broadcast of every parameter's, the offsets' included.

    :param length: Length in m.
    :param voltage: Voltage in V (sign convention for electron-like
        particles).
    :param phase: Phase in radians / 2 pi.
    :param frequency: RF frequency in Hz.
    :param misalignment: Misalignment ``(dx, dy)`` in m.
    :param tilt: Tilt angle in the x-y plane in rad.
    :param num_steps: Number of drift-kick-drift steps (the map takes one).
    :param tracking_method: Only ``"drift_kick_drift"``.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["drift_kick_drift"]

    def __init__(
        self,
        length: torch.Tensor | float,
        voltage: torch.Tensor | float | None = None,
        phase: torch.Tensor | float | None = None,
        frequency: torch.Tensor | float | None = None,
        misalignment: torch.Tensor | tuple | None = None,
        tilt: torch.Tensor | float | None = None,
        num_steps: int = 1,
        tracking_method: str = "drift_kick_drift",
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
            voltage=voltage if voltage is not None else 0.0,
            phase=phase if phase is not None else 0.0,
            frequency=frequency if frequency is not None else 0.0,
            misalignment=misalignment if misalignment is not None else (0.0, 0.0),
            tilt=tilt if tilt is not None else 0.0,
        )
        self.num_steps = num_steps
        self._init_element(name, sanitize_name, metadata, tracking_method)

    @property
    def is_skippable(self) -> bool:
        return False

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.voltage)

    def _track_drift_kick_drift(self, incoming: Beam) -> ParticleBeam:
        incoming = require_particle_beam(incoming)
        mc2 = incoming.species.mass_eV
        z, pz, p0c = bmadx.cheetah_to_bmad_z_pz(incoming.tau, incoming.p, incoming.energy, mc2)
        x_offset, y_offset = self.misalignment[..., 0], self.misalignment[..., 1]
        x, px, y, py = bmadx.offset_particle_set(
            x_offset, y_offset, self.tilt, incoming.x, incoming.px, incoming.y, incoming.py
        )
        x, y, z = bmadx.track_a_drift(self.length / 2, x, px, y, py, z, pz, p0c, mc2)

        voltage = self.voltage * -1 * incoming.species.num_elementary_charges / p0c
        k_rf = 2 * math.pi * self.frequency / speed_of_light
        # The phase that the particle sees.
        phase = (
            2
            * math.pi
            * (
                self.phase[..., None]
                - bmadx.particle_rf_time(z, pz, p0c, mc2) * self.frequency[..., None]
            )
        )
        px = px + voltage[..., None] * torch.sin(phase)

        p0c_ = p0c[..., None]
        beta_old = (1 + pz) * p0c_ / torch.sqrt(torch.square((1 + pz) * p0c_) + torch.square(mc2))
        E_old = (1 + pz) * p0c_ / beta_old
        E_new = E_old + voltage[..., None] * torch.cos(phase) * k_rf[..., None] * x * p0c_
        pc = torch.sqrt(torch.square(E_new) - torch.square(mc2))
        beta = pc / E_new
        pz = (pc - p0c_) / p0c_
        z = z * beta / beta_old

        x, y, z = bmadx.track_a_drift(self.length / 2, x, px, y, py, z, pz, p0c, mc2)
        x, px, y, py = bmadx.offset_particle_unset(x_offset, y_offset, self.tilt, x, px, y, py)
        tau, delta, ref_energy = bmadx.bmad_to_cheetah_z_pz(z, pz, p0c, mc2)
        return dkd_outgoing(incoming, (x, px, y, py, tau, delta), ref_energy, self.length)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "length",
            "voltage",
            "phase",
            "frequency",
            "misalignment",
            "tilt",
            "num_steps",
        ]
