"""Bmad-X coordinate system and nonlinear tracking maps (counterpart of
``cheetah_tpu/utils/bmadx.py``).

Reference quantities (``ref_energy``, ``p0c``, ``mc2``) have the beam's
vector shape ``(...)``; per-particle quantities have shape
``(..., num_particles)``; ``[..., None]`` aligns the two. Negative focusing
strengths go through the even extensions
:func:`~cheetah_tpu_torch.utils.maths.cos_sqrt` and
:func:`~cheetah_tpu_torch.utils.maths.sinc_sqrt` instead of complex
arithmetic.
"""

from __future__ import annotations

import math

import torch

from cheetah_tpu_torch.constants import speed_of_light
from cheetah_tpu_torch.utils.maths import (
    cos_sinc_sqrt_pm,
    cos_sinc_sqrt_series_pm,
    cos_sqrt,
    sinc_sqrt,
)


def cheetah_to_bmad_z_pz(
    tau: torch.Tensor, delta: torch.Tensor, ref_energy: torch.Tensor, mc2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheetah longitudinal coordinates ``(tau, delta)`` to Bmad ``(z, pz)``
    plus the reference momentum ``p0c``."""
    p0c = torch.sqrt(torch.square(ref_energy) - torch.square(mc2))
    energy = ref_energy[..., None] + delta * p0c[..., None]
    p = torch.sqrt(torch.square(energy) - torch.square(mc2))
    beta = p / energy
    z = -beta * tau
    pz = (p - p0c[..., None]) / p0c[..., None]
    return z, pz, p0c


def bmad_to_cheetah_z_pz(
    z: torch.Tensor, pz: torch.Tensor, p0c: torch.Tensor, mc2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bmad longitudinal coordinates ``(z, pz)`` to Cheetah ``(tau, delta)``
    plus the reference energy."""
    ref_energy = torch.sqrt(torch.square(p0c) + torch.square(mc2))
    p = (1.0 + pz) * p0c[..., None]
    energy = torch.sqrt(torch.square(p) + torch.square(mc2))
    beta = p / energy
    tau = -z / beta
    delta = (energy - ref_energy[..., None]) / p0c[..., None]
    return tau, delta, ref_energy


def cheetah_to_bmad_coords(
    cheetah_coords: torch.Tensor, ref_energy: torch.Tensor, mc2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full 7D Cheetah coordinates to 6D Bmad coordinates plus ``p0c``."""
    z, pz, p0c = cheetah_to_bmad_z_pz(
        cheetah_coords[..., 4], cheetah_coords[..., 5], ref_energy, mc2
    )
    bmad_coords = torch.cat([cheetah_coords[..., :4], z[..., None], pz[..., None]], dim=-1)
    return bmad_coords, p0c


def bmad_to_cheetah_coords(
    bmad_coords: torch.Tensor, p0c: torch.Tensor, mc2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """6D Bmad coordinates to 7D Cheetah coordinates plus the reference
    energy."""
    tau, delta, ref_energy = bmad_to_cheetah_z_pz(
        bmad_coords[..., 4], bmad_coords[..., 5], p0c, mc2
    )
    cheetah_coords = torch.cat(
        [bmad_coords[..., :4], tau[..., None], delta[..., None], torch.ones_like(tau[..., None])],
        dim=-1,
    )
    return cheetah_coords, ref_energy


def offset_particle_set(
    x_offset: torch.Tensor,
    y_offset: torch.Tensor,
    tilt: torch.Tensor,
    x_lab: torch.Tensor,
    px_lab: torch.Tensor,
    y_lab: torch.Tensor,
    py_lab: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lab frame to the (tilted, offset) element frame."""
    s = torch.sin(tilt)[..., None]
    c = torch.cos(tilt)[..., None]
    x_int = x_lab - x_offset[..., None]
    y_int = y_lab - y_offset[..., None]
    x_ele = x_int * c + y_int * s
    y_ele = -x_int * s + y_int * c
    px_ele = px_lab * c + py_lab * s
    py_ele = -px_lab * s + py_lab * c
    return x_ele, px_ele, y_ele, py_ele


def offset_particle_unset(
    x_offset: torch.Tensor,
    y_offset: torch.Tensor,
    tilt: torch.Tensor,
    x_ele: torch.Tensor,
    px_ele: torch.Tensor,
    y_ele: torch.Tensor,
    py_ele: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Element frame back to the lab frame."""
    s = torch.sin(tilt)[..., None]
    c = torch.cos(tilt)[..., None]
    x_int = x_ele * c - y_ele * s
    y_int = x_ele * s + y_ele * c
    x_lab = x_int + x_offset[..., None]
    y_lab = y_int + y_offset[..., None]
    px_lab = px_ele * c - py_ele * s
    py_lab = px_ele * s + py_ele * c
    return x_lab, px_lab, y_lab, py_lab


def low_energy_z_correction(
    pz: torch.Tensor, p0c: torch.Tensor, mc2: torch.Tensor, ds: torch.Tensor
) -> torch.Tensor:
    """Correction of the z-coordinate change for particle speed < c:
    ``dz = (ds - d_particle) + ds (beta - beta_ref) / beta_ref``."""
    p0c_ = p0c[..., None]
    beta = (1 + pz) * p0c_ / torch.sqrt(torch.square((1 + pz) * p0c_) + torch.square(mc2))
    beta0 = p0c / torch.sqrt(torch.square(p0c) + torch.square(mc2))
    e_tot = torch.sqrt(torch.square(p0c) + torch.square(mc2))

    beta0_ = beta0[..., None]
    e_tot_ = e_tot[..., None]
    beta02 = torch.square(beta0_)
    mc2_over_e2 = torch.square(mc2 / e_tot_)

    evaluation = mc2 * torch.square(beta0_ * pz)
    taylor = (
        ds[..., None]
        * pz
        * (
            1
            - 3 * (pz * beta02) / 2
            + torch.square(pz) * beta02 * (2 * beta02 - mc2_over_e2 / 2)
        )
        * mc2_over_e2
    )
    exact = ds[..., None] * (beta - beta0_) / beta0_
    return torch.where(evaluation < 3e-7 * e_tot_, taylor, exact)


def calculate_quadrupole_coefficients(
    k1: torch.Tensor, length: torch.Tensor, rel_p: torch.Tensor
) -> tuple[list[list[torch.Tensor]], list[torch.Tensor]]:
    """2x2 quadrupole transfer-matrix entries and z-change coefficients for
    one drift-kick-drift step.

    :param k1: Quadrupole strength (``k1 > 0`` means defocusing), per particle.
    :param length: Step length.
    :param rel_p: Relative momentum ``P/P0`` per particle.
    :return: ``[[a11, a12], [a21, a22]]`` and ``[c1, c2, c3]`` with
        ``z += c1 x0^2 + c2 x0 px0 + c3 px0^2``.
    """
    length_ = length[..., None]
    arg = -k1 * torch.square(length_)
    return _quad_plane(k1, cos_sqrt(arg), sinc_sqrt(arg), length_, rel_p)


def _quad_plane(
    k1: torch.Tensor,
    cx: torch.Tensor,
    si: torch.Tensor,
    length_: torch.Tensor,
    rel_p: torch.Tensor,
) -> tuple[list[list[torch.Tensor]], list[torch.Tensor]]:
    """One plane's 2x2 matrix and z-change coefficients from the focusing
    functions ``cx = cos_sqrt(-k1 L^2)`` and ``si = sinc_sqrt(-k1 L^2)``."""
    sx = si * length_
    a = [[cx, sx / rel_p], [k1 * sx * rel_p, cx]]
    c = [
        k1 * (-cx * sx + length_) / 4,
        -k1 * torch.square(sx) / (2 * rel_p),
        -(cx * sx + length_) / (4 * torch.square(rel_p)),
    ]
    return a, c


def calculate_quadrupole_coefficients_both(
    k1: torch.Tensor, length: torch.Tensor, rel_p: torch.Tensor
) -> tuple[tuple, tuple]:
    """Both transverse planes' coefficients, ``(calculate_quadrupole_coefficients(
    -k1, ...), calculate_quadrupole_coefficients(k1, ...))``, from one
    :func:`~cheetah_tpu_torch.utils.maths.cos_sinc_sqrt_pm` (the two
    planes' arguments are ``+-k1 L^2``)."""
    length_ = length[..., None]
    u = k1 * torch.square(length_)  # arg of the x plane (strength -k1)
    cx, six, cy, siy = cos_sinc_sqrt_pm(u)
    return (
        _quad_plane(-k1, cx, six, length_, rel_p),
        _quad_plane(k1, cy, siy, length_, rel_p),
    )


def calculate_quadrupole_coefficients_chromatic(
    k1_design: torch.Tensor, length: torch.Tensor, pz: torch.Tensor
) -> tuple[tuple, tuple]:
    """Both planes' quadrupole coefficients with the momentum dependence
    factored out of the transcendentals.

    Equal to machine precision to :func:`calculate_quadrupole_coefficients_both`
    with ``k1 = k1_design / rel_p``. The argument ``u / rel_p`` (``u =
    k1_design L^2``) is an outer product of an instance factor and a particle
    factor, so with ``F = cos_sqrt``, ``G = sinc_sqrt`` and ``w = 1/rel_p =
    (1 + eta)^2``::

        F(a w) = F(a) F(a eta^2) - a eta G(a) G(a eta^2)
        G(a w) = (G(a) F(a eta^2) + F(a) eta G(a eta^2)) / (1 + eta)

    for both signs of ``a``: the design quartet ``F(+-u), G(+-u)`` at the
    instance shape, one ``sqrt`` per particle (:func:`sqrt_one`), and the
    transcendental-free series
    (:func:`~cheetah_tpu_torch.utils.maths.cos_sinc_sqrt_series_pm`) at
    ``t = u eta^2``, exact to machine precision for ``|t| <= 256``.

    :param k1_design: Design quadrupole strength (not divided by ``rel_p``),
        broadcastable against the particle axis (e.g. shape ``(..., 1)``).
    :param length: Step length.
    :param pz: Bmad momentum deviation per particle; ``rel_p = 1 + pz``.
    """
    rel_p = 1.0 + pz
    length_ = length[..., None]
    u = k1_design * torch.square(length_)  # x-plane design arg (strength -k1)

    fu, gu, fmu, gmu = cos_sinc_sqrt_pm(u)

    s1 = sqrt_one(pz)  # sqrt(rel_p) - 1, exact relative precision
    inv_1p_eta = 1.0 + s1  # 1/(1 + eta) = sqrt(rel_p)
    eta = -s1 / inv_1p_eta  # 1/sqrt(rel_p) - 1, exact relative precision

    t = u * torch.square(eta)
    ft, gt, fmt, gmt = cos_sinc_sqrt_series_pm(t)

    u_eta = u * eta
    cx = fu * ft - u_eta * (gu * gt)
    six = (gu * ft + fu * (eta * gt)) * inv_1p_eta
    cy = fmu * fmt + u_eta * (gmu * gmt)
    siy = (gmu * fmt + fmu * (eta * gmt)) * inv_1p_eta

    k1 = k1_design / rel_p
    return (
        _quad_plane(-k1, cx, six, length_, rel_p),
        _quad_plane(k1, cy, siy, length_, rel_p),
    )


def sqrt_one(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(1 + x) - 1`` to machine precision."""
    sq = torch.sqrt(1 + x)
    return x / (sq + 1)


def track_a_drift(
    length: torch.Tensor,
    x_in: torch.Tensor,
    px_in: torch.Tensor,
    y_in: torch.Tensor,
    py_in: torch.Tensor,
    z_in: torch.Tensor,
    pz_in: torch.Tensor,
    p0c: torch.Tensor,
    mc2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (nonlinear) drift tracking."""
    P = 1.0 + pz_in
    Px = px_in / P
    Py = py_in / P
    Pxy2 = torch.square(Px) + torch.square(Py)
    Pl = torch.sqrt(1.0 - Pxy2)

    length_ = length[..., None]
    dz = length_ * (
        sqrt_one(
            (torch.square(mc2) * (2 * pz_in + torch.square(pz_in)))
            / (torch.square(p0c[..., None] * P) + torch.square(mc2))
        )
        + sqrt_one(-Pxy2) / Pl
    )

    x_out = x_in + length_ * Px / Pl
    y_out = y_in + length_ * Py / Pl
    z_out = z_in + dz
    return x_out, y_out, z_out


def particle_rf_time(
    z: torch.Tensor, pz: torch.Tensor, p0c: torch.Tensor, mc2: torch.Tensor
) -> torch.Tensor:
    """RF arrival time of each particle."""
    p0c_ = p0c[..., None]
    beta = (1 + pz) * p0c_ / torch.sqrt(torch.square((1 + pz) * p0c_) + torch.square(mc2))
    return -z / (beta * speed_of_light)


def sinc(x: torch.Tensor) -> torch.Tensor:
    """``sin(x) / x`` with value 1 at 0."""
    return torch.sinc(x / math.pi)


def cosc(x: torch.Tensor) -> torch.Tensor:
    """``(cos(x) - 1) / x^2 = -0.5 sinc(x/2)^2``."""
    return -0.5 * torch.square(sinc(x / 2))
