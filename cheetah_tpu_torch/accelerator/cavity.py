"""Accelerating cavity (counterpart of ``cheetah_tpu/accelerator/cavity.py``)."""

from __future__ import annotations

import math
import warnings
from typing import Any

import torch

from cheetah_tpu_torch.accelerator.element import Element, any_nonzero
from cheetah_tpu_torch.constants import speed_of_light
from cheetah_tpu_torch.ops.transfer_maps import matrix7, with_entries
from cheetah_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import is_transformed
from cheetah_tpu_torch.utils.maths import log1pdiv
from cheetah_tpu_torch.utils.physics import compute_relativistic_factors
from cheetah_tpu_torch.utils.warnings import PhysicsWarning


def _safe(x: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    return torch.where(bad, torch.ones_like(x), x)


def _with_longitudinal(
    vectors: torch.Tensor, tau: torch.Tensor, delta: torch.Tensor
) -> torch.Tensor:
    """``vectors (..., 7)`` with ``tau`` and ``delta`` in columns 4 and 5,
    all broadcast to one shape; built out of place."""
    shape = torch.broadcast_shapes(vectors.shape[:-1], tau.shape, delta.shape)
    vectors = vectors.expand(*shape, 7)
    return torch.cat(
        [vectors[..., :4], tau.expand(shape)[..., None], delta.expand(shape)[..., None],
         vectors[..., 6:]],
        dim=-1,
    )


class Cavity(Element):
    """Accelerating cavity.

    ``track`` applies the cavity's R-matrix, then recomputes the relative
    energy deviation with the RF cosine and adds the longitudinal
    second-order terms T566/T556/T555 where the cavity accelerates; the
    beam's reference ``energy`` changes.

    As in the JAX package:

    - the accelerating branch is chosen per vector instance, with guarded
      denominators, so a batch of voltages may mix both branches;
    - ``is_skippable`` is decided on the host: with ``skippable_when_off``
      (the default), a cavity whose voltage is zero and needs no gradient
      fuses into the surrounding linear run. The decision is made when
      ``voltage`` is assigned (one read of its value then), never inside
      ``track``, so tracking reads nothing back from the card and can be
      captured in a CUDA graph. A voltage changed in place keeps the old
      decision: assign it instead;
    - at a zero-crossing phase (``+-90 deg``) the standing-wave ``r55`` term
      blows up; a :class:`PhysicsWarning` is given when an active
      standing-wave cavity is set within 1e-3 deg of one.

    :param length: Length in m.
    :param voltage: Cavity voltage in V.
    :param phase: Cavity phase in degrees.
    :param frequency: RF frequency in Hz.
    :param cavity_type: ``"standing_wave"`` or ``"traveling_wave"``.
    :param skippable_when_off: Whether a cavity at zero voltage fuses with
        its neighbours; ``False`` always runs the bespoke ``track``.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    def __init__(
        self,
        length: torch.Tensor | float,
        voltage: torch.Tensor | float | None = None,
        phase: torch.Tensor | float | None = None,
        frequency: torch.Tensor | float | None = None,
        cavity_type: str = "standing_wave",
        skippable_when_off: bool = True,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if cavity_type not in ("standing_wave", "traveling_wave"):
            raise ValueError(f"Invalid cavity type: {cavity_type}")
        self.cavity_type = cavity_type
        self.skippable_when_off = skippable_when_off
        self._register_parameters(
            ("length", length),
            dtype,
            device,
            voltage=voltage if voltage is not None else 0.0,
            phase=phase if phase is not None else 0.0,
            frequency=frequency if frequency is not None else 0.0,
        )
        self._init_element(name, sanitize_name, metadata)
        self._voltage_changed()

    def __setattr__(self, key: str, value: Any) -> None:
        super().__setattr__(key, value)
        if key in ("voltage", "phase") and hasattr(self, "_voltage_is_off"):
            self._voltage_changed()

    def _voltage_changed(self) -> None:
        """Read the voltage (and phase) on the host once: whether the cavity
        is off, and the zero-crossing warning. A voltage that needs a
        gradient or is a ``torch.func`` transform's argument is never off,
        and a transform's arguments are not read (as the JAX package leaves
        traced values alone)."""
        voltage, phase = self.voltage, self.phase
        if is_transformed(voltage) or is_transformed(phase):
            self._voltage_is_off = False
            return
        voltage, phase = voltage.detach().cpu(), phase.detach().cpu()
        self._voltage_is_off = not self.voltage.requires_grad and bool(torch.all(voltage == 0))
        if self.cavity_type != "standing_wave":
            return
        at_crossing = (torch.abs(torch.remainder(phase, 180.0) - 90.0) < 1e-3) & (voltage != 0)
        if bool(torch.any(at_crossing)):
            warnings.warn(
                f"Cavity {getattr(self, 'name', '?')} is at a zero-crossing "
                "phase (+-90 deg) with non-zero voltage: the standing-wave "
                "r55 model is numerically invalid there (non-finite tracking "
                "output). Offset the phase or set voltage to zero.",
                category=PhysicsWarning,
                stacklevel=3,
            )

    @property
    def is_skippable(self) -> bool:
        return self.skippable_when_off and self._voltage_is_off

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.voltage)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return self._cavity_rmatrix(energy, species)

    def _track(self, incoming: Beam) -> Beam:
        gamma0, igamma2, beta0 = compute_relativistic_factors(
            incoming.energy, incoming.species.mass_eV
        )
        phi = torch.deg2rad(self.phase)

        tm = self.first_order_transfer_map(incoming.energy, incoming.species)
        delta_energy = self.voltage * torch.cos(phi) * incoming.species.num_elementary_charges * -1

        k = 2.0 * math.pi * self.frequency / speed_of_light
        outgoing_energy = incoming.energy + delta_energy
        gamma1, _, beta1 = compute_relativistic_factors(outgoing_energy, incoming.species.mass_eV)

        dgamma = self.voltage / incoming.species.mass_eV

        # Longitudinal second-order terms; the accelerating branch per
        # instance, with guarded denominators.
        accelerating = delta_energy > 0
        T566_default = 1.5 * self.length * igamma2 / beta0**3
        gdiff = torch.where(accelerating, gamma0 - gamma1, torch.ones_like(gamma0))
        T566_accel = (
            self.length
            * (beta0**3 * gamma0**3 - beta1**3 * gamma1**3)
            / (2.0 * beta0 * beta1**3 * gamma0 * gdiff * gamma1**3)
        )
        T556_accel = (
            beta0
            * k
            * self.length
            * dgamma
            * gamma0
            * (beta1**3 * gamma1**3 + beta0 * (gamma0 - gamma1**3))
            * torch.sin(phi)
            / (beta1**3 * gamma1**3 * torch.square(gdiff))
        )
        T555_accel = (
            torch.square(beta0)
            * torch.square(k)
            * self.length
            * dgamma
            / 2.0
            * (
                dgamma
                * (
                    2.0 * gamma0 * gamma1**3 * (beta0 * beta1**3 - 1.0)
                    + torch.square(gamma0)
                    + 3.0 * torch.square(gamma1)
                    - 2.0
                )
                / (beta1**3 * gamma1**3 * gdiff**3)
                * torch.square(torch.sin(phi))
                - (gamma1 * gamma0 * (beta1 * beta0 - 1.0) + 1.0)
                / (beta1 * gamma1 * torch.square(gdiff))
                * torch.cos(phi)
            )
        )
        T566 = torch.where(accelerating, T566_accel, T566_default)
        T556 = torch.where(accelerating, T556_accel, torch.zeros_like(T556_accel))
        T555 = torch.where(accelerating, T555_accel, torch.zeros_like(T555_accel))

        # The relative energy deviation recomputed from the RF cosine.
        if isinstance(incoming, ParameterBeam):
            mu_in, cov_in = incoming.mu, incoming.cov
            mu = torch.matmul(tm, mu_in[..., None]).squeeze(-1)
            cov = tm @ cov_in @ tm.transpose(-1, -2)
            delta = mu_in[..., 5] * incoming.energy * beta0 / (
                outgoing_energy * beta1
            ) + self.voltage * beta0 / (outgoing_energy * beta1) * (
                torch.cos(-mu_in[..., 4] * beta0 * k + phi) - torch.cos(phi)
            )
            tau = mu[..., 4] + (
                T566 * torch.square(mu_in[..., 5])
                + T556 * mu_in[..., 4] * mu_in[..., 5]
                + T555 * torch.square(mu_in[..., 4])
            )
            longitudinal = (
                T566 * torch.square(cov_in[..., 5, 5])
                + T556 * cov_in[..., 4, 5] * cov_in[..., 5, 5]
                + T555 * torch.square(cov_in[..., 4, 4])
            )
            cov = with_entries(
                cov,
                {
                    (5, 5): cov_in[..., 5, 5],
                    (4, 4): longitudinal,
                    (4, 5): longitudinal,
                    (5, 4): longitudinal,
                },
            )
            return ParameterBeam(
                _with_longitudinal(mu, tau, delta),
                cov,
                outgoing_energy,
                total_charge=incoming.total_charge,
                s=incoming.s + self.length,
                species=incoming.species,
            )

        particles_in = incoming.particles
        particles = torch.matmul(particles_in, tm.transpose(-1, -2))
        delta = particles_in[..., 5] * incoming.energy[..., None] * beta0[..., None] / (
            outgoing_energy[..., None] * beta1[..., None]
        ) + self.voltage[..., None] * beta0[..., None] / (
            outgoing_energy[..., None] * beta1[..., None]
        ) * (
            torch.cos(-particles_in[..., 4] * beta0[..., None] * k[..., None] + phi[..., None])
            - torch.cos(phi)[..., None]
        )
        tau = particles[..., 4] + (
            T566[..., None] * torch.square(particles_in[..., 5])
            + T556[..., None] * particles_in[..., 4] * particles_in[..., 5]
            + T555[..., None] * torch.square(particles_in[..., 4])
        )
        return ParticleBeam(
            _with_longitudinal(particles, tau, delta),
            outgoing_energy,
            particle_charges=incoming.particle_charges,
            survival_probabilities=incoming.survival_probabilities,
            s=incoming.s + self.length,
            species=incoming.species,
        )

    def _cavity_rmatrix(self, energy: torch.Tensor, species: Species) -> torch.Tensor:
        """R-matrix of the cavity: standing wave by the
        Rosenzweig-Serafini alpha model, travelling wave with entry and exit
        focusing."""
        phi = torch.deg2rad(self.phase)
        effective_voltage = -self.voltage * species.num_elementary_charges
        delta_energy = effective_voltage * torch.cos(phi)

        Ei = energy / species.mass_eV
        dE = delta_energy / species.mass_eV
        Ef = Ei + dE
        Ep = dE / self.length  # Derivative of the energy

        k = 2 * math.pi * self.frequency / speed_of_light

        if self.cavity_type == "standing_wave":
            alpha = (
                math.sqrt(0.125) * effective_voltage / energy * log1pdiv(delta_energy / energy)
            )
            beta0 = torch.sqrt(1 - 1 / torch.square(Ei))
            beta1 = torch.sqrt(1 - 1 / torch.square(Ef))

            r11 = torch.cos(alpha) - math.sqrt(2.0) * torch.cos(phi) * torch.sin(alpha)
            r12 = torch.sinc(alpha / math.pi) * log1pdiv(delta_energy / energy) * self.length
            r21 = -(
                effective_voltage
                / ((energy + delta_energy) * math.sqrt(2.0) * self.length)
                * (0.5 + torch.square(torch.cos(phi)))
                * torch.sin(alpha)
            )
            r22 = Ei / Ef * (torch.cos(alpha) + math.sqrt(2.0) * torch.cos(phi) * torch.sin(alpha))

            dE_safe = _safe(dE, dE == 0)
            r55 = 1.0 + torch.where(
                dE != 0.0,
                k
                * self.length
                * beta0
                * torch.tan(phi)
                * (Ei * Ef * (beta0 * beta1 - 1) + 1)
                / (beta1 * Ef * dE_safe),
                torch.zeros_like(dE),
            )
            r56 = -self.length / (torch.square(Ef) * Ei * beta1) * (Ef + Ei) / (beta1 + beta0)
            r65 = k * torch.sin(phi) * effective_voltage / (beta1 * (energy + delta_energy))
            r66 = Ei / Ef * beta0 / beta1
        else:  # traveling_wave
            # Rosenzweig and Serafini, PhysRevE Vol. 49, p. 1599 (1994).
            body_01 = self.length * log1pdiv(dE / Ei)
            body_11 = Ei / Ef
            f_entry_10 = -Ep / (2 * Ei)
            f_exit_10 = Ep / (2 * Ef)

            # M = M_f_exit @ M_body @ M_f_entry, expanded for 2x2 matrices.
            r11 = 1.0 + body_01 * f_entry_10
            r12 = body_01
            r21 = f_exit_10 * r11 + body_11 * f_entry_10
            r22 = f_exit_10 * body_01 + body_11
            r55 = torch.ones_like(self.length)
            r56 = torch.zeros_like(self.length)
            r65 = k * torch.sin(phi) * effective_voltage / (energy + delta_energy)
            r66 = r22

        r11, r12, r21, r22, r55, r56, r65, r66 = torch.broadcast_tensors(
            r11, r12, r21, r22, r55, r56, r65, r66
        )
        return matrix7(
            {
                (0, 0): r11,
                (0, 1): r12,
                (1, 0): r21,
                (1, 1): r22,
                (2, 2): r11,
                (2, 3): r12,
                (3, 2): r21,
                (3, 3): r22,
                (4, 4): r55,
                (4, 5): r56,
                (5, 4): r65,
                (5, 5): r66,
            },
            r11.shape,
            r11,
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "length",
            "voltage",
            "phase",
            "frequency",
            "cavity_type",
            *([] if self.skippable_when_off else ["skippable_when_off"]),
        ]
