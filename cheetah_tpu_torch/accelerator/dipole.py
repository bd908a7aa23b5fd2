"""Dipole (sector bending magnet), counterpart of
``cheetah_tpu/accelerator/dipole.py``."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    any_nonzero,
    dkd_outgoing,
    require_particle_beam,
)
from cheetah_tpu_torch.ops.transfer_maps import (
    base_rmatrix,
    base_ttensor,
    matrix7,
    rotation_matrix,
    with_first_order,
)
from cheetah_tpu_torch.particles import Beam, ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils import bmadx
from cheetah_tpu_torch.utils.maths import sqrta2minusbdiva


class Dipole(Element):
    """Dipole magnet (by default a sector bending magnet).

    :param length: Length in m.
    :param angle: Deflection angle in rad.
    :param k1: Focusing strength in 1/m^2 (``"linear"`` and
        ``"second_order"`` tracking only).
    :param dipole_e1: Inclination of the entrance face in rad.
    :param dipole_e2: Inclination of the exit face in rad.
    :param tilt: Tilt in the x-y plane in rad.
    :param gap: Magnet gap in m (MAD/ELEGANT ``HGAP = gap/2``).
    :param gap_exit: Magnet gap at the exit in m, if different from ``gap``.
    :param fringe_integral: Fringe field integral of the entrance face.
    :param fringe_integral_exit: Fringe field integral of the exit face, if
        different.
    :param fringe_at: Where ``"drift_kick_drift"`` tracking applies fringe
        fields: ``"neither"``, ``"entrance"``, ``"exit"`` or ``"both"``.
    :param fringe_type: Only ``"linear_edge"`` is supported.
    :param tracking_method: ``"linear"``, ``"second_order"`` or
        ``"drift_kick_drift"``.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.
    """

    supported_tracking_methods = ["linear", "second_order", "drift_kick_drift"]

    def __init__(
        self,
        length: torch.Tensor | float,
        angle: torch.Tensor | float | None = None,
        k1: torch.Tensor | float | None = None,
        dipole_e1: torch.Tensor | float | None = None,
        dipole_e2: torch.Tensor | float | None = None,
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
        super().__init__()
        gap = gap if gap is not None else 0.0
        fringe_integral = fringe_integral if fringe_integral is not None else 0.0
        self._register_parameters(
            ("length", length),
            dtype,
            device,
            angle=angle if angle is not None else 0.0,
            k1=k1 if k1 is not None else 0.0,
            dipole_e1=dipole_e1 if dipole_e1 is not None else 0.0,
            dipole_e2=dipole_e2 if dipole_e2 is not None else 0.0,
            tilt=tilt if tilt is not None else 0.0,
            gap=gap,
            gap_exit=gap_exit if gap_exit is not None else gap,
            fringe_integral=fringe_integral,
            fringe_integral_exit=(
                fringe_integral_exit if fringe_integral_exit is not None else fringe_integral
            ),
        )
        self.fringe_at = fringe_at
        self.fringe_type = fringe_type
        self._init_element(name, sanitize_name, metadata, tracking_method)

    @property
    def hx(self) -> torch.Tensor:
        """Curvature of the trajectory (zero length is not physical)."""
        return self.angle / self.length

    @property
    def is_skippable(self) -> bool:
        return self.tracking_method == "linear"

    @property
    def is_active(self) -> bool:
        return any_nonzero(self.angle)

    # ------------------------------------------------------------------
    # Linear and second-order maps
    # ------------------------------------------------------------------

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        R = base_rmatrix(self.length, self.k1, self.hx, species, energy)
        R = self._transfer_map_exit() @ R @ self._transfer_map_enter()
        rotation = rotation_matrix(self.tilt)
        return rotation.transpose(-1, -2) @ R @ rotation

    def second_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        R_enter = self._transfer_map_enter()
        R_exit = self._transfer_map_exit()
        T = base_ttensor(
            self.length, self.k1, torch.zeros_like(self.length), self.hx, species, energy
        )
        T = with_first_order(T, base_rmatrix(self.length, self.k1, self.hx, species, energy))
        T = torch.einsum("...ij,...jkl,...kn,...lm->...inm", R_exit, T, R_enter, R_enter)
        rotation = rotation_matrix(self.tilt)
        return torch.einsum("...ji,...jkl,...kn,...lm->...inm", rotation, T, rotation, rotation)

    def _face_map(self, angle: torch.Tensor, fringe_integral: torch.Tensor) -> torch.Tensor:
        """Pole-face rotation and fringe map of one face."""
        sec_e = 1.0 / torch.cos(angle)
        phi = fringe_integral * self.hx * self.gap * sec_e * (1 + torch.square(torch.sin(angle)))
        r10 = self.hx * torch.tan(angle)
        r32 = -self.hx * torch.tan(angle - phi)
        r10, r32 = torch.broadcast_tensors(r10, r32)
        return matrix7({(1, 0): r10, (3, 2): r32}, r10.shape, r10)

    def _transfer_map_enter(self) -> torch.Tensor:
        """Pole-face rotation and fringe map of the entrance face."""
        return self._face_map(self.dipole_e1, self.fringe_integral)

    def _transfer_map_exit(self) -> torch.Tensor:
        """Pole-face rotation and fringe map of the exit face (with the
        entrance's ``gap``, as in the JAX package)."""
        return self._face_map(self.dipole_e2, self.fringe_integral_exit)

    # ------------------------------------------------------------------
    # Drift-kick-drift (exact Bmad-X sector bend)
    # ------------------------------------------------------------------

    def _track_drift_kick_drift(self, incoming: Beam) -> ParticleBeam:
        """Exact sector-bend body with linear fringes. The tilt's frame
        rotations are always applied: at zero tilt they are the identity,
        bit for bit (``sin(0)`` and ``cos(0)`` are exact), and deciding to
        skip them would read the tilt back from the card."""
        incoming = require_particle_beam(incoming)
        mc2 = incoming.species.mass_eV
        zero = torch.zeros_like(self.tilt)
        z, pz, p0c = bmadx.cheetah_to_bmad_z_pz(incoming.tau, incoming.p, incoming.energy, mc2)
        x, px, y, py = bmadx.offset_particle_set(
            zero, zero, self.tilt, incoming.x, incoming.px, incoming.y, incoming.py
        )
        if self.fringe_at in ("entrance", "both"):
            px, py = self._bmadx_fringe_linear("entrance", x, px, y, py)
        x, px, y, py, z, pz = self._bmadx_body(x, px, y, py, z, pz, p0c, mc2)
        if self.fringe_at in ("exit", "both"):
            px, py = self._bmadx_fringe_linear("exit", x, px, y, py)
        x, px, y, py = bmadx.offset_particle_unset(zero, zero, self.tilt, x, px, y, py)
        tau, delta, ref_energy = bmadx.bmad_to_cheetah_z_pz(z, pz, p0c, mc2)
        return dkd_outgoing(incoming, (x, px, y, py, tau, delta), ref_energy, self.length)

    def _bmadx_body(
        self,
        x: torch.Tensor,
        px: torch.Tensor,
        y: torch.Tensor,
        py: torch.Tensor,
        z: torch.Tensor,
        pz: torch.Tensor,
        p0c: torch.Tensor,
        mc2: torch.Tensor,
    ) -> tuple[torch.Tensor, ...]:
        """Exact sector-bend body map.

        The entry angle ``phi1 = arcsin(px / px_norm)`` enters only through
        its sine and cosine (``cos(phi1) = sqrt(1 - sin^2) >= 0`` on
        ``[-pi/2, pi/2]``), ``A = angle + phi1`` through angle addition, and
        the arc angle ``theta_p`` through ``sin(theta_p / 2) = -(cos_A Lcu +
        sin_A Lcv) / Lc``: one ``arcsin`` per particle, where a direct
        evaluation takes arcsin, atan2 and four sin/cos, and no cancellation
        of O(1) angles (``cheetah_tpu/accelerator/dipole.py:257-364``).
        """
        length = self.length[..., None]
        angle = self.angle[..., None]

        px_norm = torch.sqrt(torch.square(1 + pz) - torch.square(py))
        sin_phi1 = px / px_norm
        cos_phi1 = torch.sqrt((1 - sin_phi1) * (1 + sin_phi1))
        sin_angle = torch.sin(angle)  # instance-shaped
        cos_angle = torch.cos(angle)
        # A = angle + phi1 by angle addition.
        sin_A = sin_angle * cos_phi1 + cos_angle * sin_phi1
        cos_A = cos_angle * cos_phi1 - sin_angle * sin_phi1

        g = self.angle / self.length
        gp = g[..., None] / px_norm

        sinc_angle = bmadx.sinc(angle)
        alpha = 2 * (1 + g[..., None] * x) * sin_A * length * sinc_angle - gp * torch.square(
            (1 + g[..., None] * x) * length * sinc_angle
        )

        x2_t1 = x * cos_angle + torch.square(length) * g[..., None] * bmadx.cosc(angle)
        x2_t2 = torch.sqrt(torch.square(cos_A) + gp * alpha)
        x2_t3 = cos_A

        c1 = x2_t1 + alpha / (x2_t2 + x2_t3)
        c2 = x2_t1 + alpha * sqrta2minusbdiva(x2_t3, gp * alpha)
        # |angle + phi1| < pi/2  <=>  cos_A > 0 on the physical branch.
        x2 = torch.where(cos_A > 0, c1, c2)

        Lcu = x2 - torch.square(length) * g[..., None] * bmadx.cosc(angle) - x * cos_angle
        Lcv = -length * sinc_angle - x * sin_angle

        # theta_p = 2 (A - pi/2 - atan2(Lcv, Lcu)), so sin(theta_p / 2) =
        # -cos(A - atan2(Lcv, Lcu)) = -(cos_A Lcu + sin_A Lcv) / Lc.
        Lc = torch.sqrt(torch.square(Lcu) + torch.square(Lcv))
        sin_half = -(cos_A * Lcu + sin_A * Lcv) / Lc
        half_p = torch.arcsin(sin_half)
        # Lp = Lc / sinc(theta_p / 2); the where guards the removable zero
        # (the ratio is 1 + theta^2/24 + ..., below one ulp for |sin_half| <
        # 1e-9 even in float64).
        tiny = torch.abs(sin_half) < 1e-9
        Lp = torch.where(
            tiny, Lc, Lc * half_p / torch.where(tiny, torch.ones_like(sin_half), sin_half)
        )

        P = p0c[..., None] * (1 + pz)  # In eV
        E = torch.sqrt(torch.square(P) + torch.square(mc2))
        E0 = torch.sqrt(torch.square(p0c) + torch.square(mc2))
        beta = P / E
        beta0 = p0c / E0

        x_f = x2
        # px_f = px_norm sin(A - theta_p), from sin/cos(theta_p) of the half angle.
        cos_half = torch.sqrt((1 - sin_half) * (1 + sin_half))
        sin_theta = 2 * sin_half * cos_half
        cos_theta = 1 - 2 * torch.square(sin_half)
        px_f = px_norm * (sin_A * cos_theta - cos_A * sin_theta)
        y_f = y + py * Lp / px_norm
        z_f = z + (beta * length / beta0[..., None]) - ((1 + pz) * Lp / px_norm)

        return x_f, px_f, y_f, py, z_f, pz

    def _bmadx_fringe_linear(
        self,
        location: str,
        x: torch.Tensor,
        px: torch.Tensor,
        y: torch.Tensor,
        py: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Linear fringe kick at the entrance or the exit."""
        g = self.angle / self.length
        entrance = location == "entrance"
        e = self.dipole_e1 if entrance else self.dipole_e2
        f_int = self.fringe_integral if entrance else self.fringe_integral_exit
        h_gap = 0.5 * (self.gap if entrance else self.gap_exit)

        hx = g * torch.tan(e)
        hy = -g * torch.tan(
            e - 2 * f_int * h_gap * g * (1 + torch.square(torch.sin(e))) / torch.cos(e)
        )
        return px + x * hx[..., None], py + y * hy[..., None]

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "length",
            "angle",
            "k1",
            "dipole_e1",
            "dipole_e2",
            "tilt",
            "gap",
            "gap_exit",
            "fringe_integral",
            "fringe_integral_exit",
            "fringe_at",
            "fringe_type",
        ]
