"""First-order transfer maps (counterpart of the linear builders in
``cheetah_tpu/ops/transfer_maps.py``).

The augmented 7th phase-space coordinate (constant 1) makes thin kicks and
misalignments expressible as matrix multiplication. All functions broadcast
over leading vector dimensions and build their maps on the device of their
inputs.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.maths import cos_sqrt, si1mdiv, sinc_sqrt
from cheetah_tpu_torch.utils.physics import compute_relativistic_factors


def _eye7(vector_shape: torch.Size, like: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(7, dtype=like.dtype, device=like.device)
    return eye.expand(*vector_shape, 7, 7).clone()


def base_rmatrix(
    length: torch.Tensor,
    k1: torch.Tensor,
    hx: torch.Tensor,
    species: Species,
    energy: torch.Tensor,
) -> torch.Tensor:
    """First-order universal 7x7 map for combined-function magnets.

    :param length: Length of the element in m.
    :param k1: Quadrupole strength in 1/m^2.
    :param hx: Curvature (1/radius) of the element in 1/m.
    :param species: Particle species of the beam.
    :param energy: Beam energy in eV.
    """
    _, igamma2, beta = compute_relativistic_factors(energy, species.mass_eV)
    length, k1, hx, igamma2, beta = torch.broadcast_tensors(length, k1, hx, igamma2, beta)

    kx2 = k1 + torch.square(hx)
    ky2 = -k1
    L2 = torch.square(length)
    cx = cos_sqrt(kx2 * L2)
    cy = cos_sqrt(ky2 * L2)
    sx = sinc_sqrt(kx2 * L2) * length
    sy = sinc_sqrt(ky2 * L2) * length

    r2 = torch.square(sinc_sqrt(0.25 * kx2 * L2))
    dx = hx * 0.5 * L2 * r2

    r56 = (
        torch.square(hx) * length**3 * si1mdiv(kx2 * L2) / torch.square(beta)
        - length / torch.square(beta) * igamma2
    )

    R = _eye7(length.shape, length)
    R[..., 0, 0] = cx
    R[..., 0, 1] = sx
    R[..., 0, 5] = dx / beta
    R[..., 1, 0] = -kx2 * sx
    R[..., 1, 1] = cx
    R[..., 1, 5] = sx * hx / beta
    R[..., 2, 2] = cy
    R[..., 2, 3] = sy
    R[..., 3, 2] = -ky2 * sy
    R[..., 3, 3] = cy
    R[..., 4, 0] = sx * hx / beta
    R[..., 4, 1] = dx / beta
    R[..., 4, 5] = r56
    return R


def drift_matrix(
    length: torch.Tensor, energy: torch.Tensor, species: Species
) -> torch.Tensor:
    """First-order map of a drift space."""
    _, igamma2, beta = compute_relativistic_factors(energy, species.mass_eV)
    length, igamma2, beta = torch.broadcast_tensors(length, igamma2, beta)

    R = _eye7(length.shape, length)
    R[..., 0, 1] = length
    R[..., 2, 3] = length
    R[..., 4, 5] = -length / torch.square(beta) * igamma2
    return R


def _rotation(cs: torch.Tensor, sn: torch.Tensor) -> torch.Tensor:
    R = _eye7(cs.shape, cs)
    R[..., 0, 0] = cs
    R[..., 0, 2] = sn
    R[..., 1, 1] = cs
    R[..., 1, 3] = sn
    R[..., 2, 0] = -sn
    R[..., 2, 2] = cs
    R[..., 3, 1] = -sn
    R[..., 3, 3] = cs
    return R


def rotation_matrix(angle: torch.Tensor) -> torch.Tensor:
    """Coordinate rotation in the x-y plane."""
    return _rotation(torch.cos(angle), torch.sin(angle))


def misalignment_matrix(
    misalignment: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry/exit affine shifts for a transversely misaligned element."""
    vector_shape = misalignment.shape[:-1]
    R_exit = _eye7(vector_shape, misalignment)
    R_exit[..., 0, 6] = misalignment[..., 0]
    R_exit[..., 2, 6] = misalignment[..., 1]

    R_entry = _eye7(vector_shape, misalignment)
    R_entry[..., 0, 6] = -misalignment[..., 0]
    R_entry[..., 2, 6] = -misalignment[..., 1]
    return R_entry, R_exit


def combined_rotation_misalignment_matrix(
    angle: torch.Tensor, misalignment: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused misalignment-then-rotation entry/exit pair."""
    vector_shape = torch.broadcast_shapes(angle.shape, misalignment.shape[:-1])
    cs = torch.cos(angle).expand(vector_shape)
    sn = torch.sin(angle).expand(vector_shape)
    mis_x = misalignment[..., 0].expand(vector_shape)
    mis_y = misalignment[..., 1].expand(vector_shape)

    tm_entry = _rotation(cs, sn)
    tm_exit = tm_entry.transpose(-1, -2).clone()
    tm_exit[..., 0, 6] = mis_x
    tm_exit[..., 2, 6] = mis_y

    tm_entry[..., 0, 6] = -mis_x * cs - mis_y * sn
    tm_entry[..., 2, 6] = mis_x * sn - mis_y * cs
    return tm_entry, tm_exit
