"""First- and second-order transfer maps (counterpart of
``cheetah_tpu/ops/transfer_maps.py``).

The augmented 7th phase-space coordinate (constant 1) makes thin kicks and
misalignments expressible as matrix multiplication. All functions broadcast
over leading vector dimensions and build their maps on the device of their
inputs.

Every map is built out of place: its computed entries are stacked and
copied at constant positions into the identity (the 7x7 maps) or into
zeros (the 7x7x7 T-tensor). No entry is written into a tensor in place, so the builders run
under ``torch.func.vmap`` and forward-mode differentiation with batched
arguments.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import constant_cache
from cheetah_tpu_torch.utils.maths import (
    cos_sqrt,
    cossqrtmcosdivdiff,
    si1mdiv,
    si2msi2divdiff,
    sicos1mdiv,
    simsidivdiff,
    sinc_sqrt,
    sipsicos3mdiv,
)
from cheetah_tpu_torch.utils.physics import compute_relativistic_factors


@constant_cache
def _flat_identity(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.eye(7, dtype=dtype, device=device).reshape(49)


@constant_cache
def _flat_identities(
    vector_shape: torch.Size, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """The flat identity for every instance of ``vector_shape``, laid out in
    full: Inductor miscompiles ``index_copy`` of the expanded identity (it
    writes every instance's entries into the one row that the expansion
    repeats, so every instance got the last one's map)."""
    return _flat_identity(dtype, device).expand(*vector_shape, 49).contiguous()


@constant_cache
def _flat_positions(positions: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor([7 * row + column for row, column in positions], device=device)


def matrix7(
    entries: dict[tuple[int, int], torch.Tensor],
    vector_shape: torch.Size,
    like: torch.Tensor,
) -> torch.Tensor:
    """The ``(*vector_shape, 7, 7)`` map with the given ``(row, column)``
    entries, each broadcast to ``vector_shape``, and the identity's
    elsewhere: the entries are stacked and copied into the flat identity at
    constant positions, out of place."""
    values = torch.stack(
        [value if value.shape == vector_shape else value.expand(vector_shape)
         for value in entries.values()],
        dim=-1,
    )
    flat = _flat_identities(vector_shape, like.dtype, like.device).index_copy(
        -1, _flat_positions(tuple(entries), like.device), values
    )
    return flat.reshape(*vector_shape, 7, 7)


@constant_cache
def _entry_mask(row: int, column: int, device: torch.device) -> torch.Tensor:
    mask = torch.zeros(7, 7, dtype=torch.bool, device=device)
    mask[row, column] = True
    return mask


def with_entries(
    matrix: torch.Tensor, entries: dict[tuple[int, int], torch.Tensor]
) -> torch.Tensor:
    """``matrix (..., 7, 7)`` with the given ``(row, column)`` entries
    replaced, out of place; the entries' vector shapes broadcast."""
    for (row, column), value in entries.items():
        matrix = torch.where(_entry_mask(row, column, matrix.device), value[..., None, None], matrix)
    return matrix


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

    return matrix7(
        {
            (0, 0): cx,
            (0, 1): sx,
            (0, 5): dx / beta,
            (1, 0): -kx2 * sx,
            (1, 1): cx,
            (1, 5): sx * hx / beta,
            (2, 2): cy,
            (2, 3): sy,
            (3, 2): -ky2 * sy,
            (3, 3): cy,
            (4, 0): sx * hx / beta,
            (4, 1): dx / beta,
            (4, 5): r56,
        },
        length.shape,
        length,
    )


def drift_matrix(
    length: torch.Tensor, energy: torch.Tensor, species: Species
) -> torch.Tensor:
    """First-order map of a drift space."""
    _, igamma2, beta = compute_relativistic_factors(energy, species.mass_eV)
    length, igamma2, beta = torch.broadcast_tensors(length, igamma2, beta)
    return matrix7(
        {(0, 1): length, (2, 3): length, (4, 5): -length / torch.square(beta) * igamma2},
        length.shape,
        length,
    )


def corrector_matrix(
    length: torch.Tensor,
    energy: torch.Tensor,
    species: Species,
    kicks: dict[int, torch.Tensor],
) -> torch.Tensor:
    """First-order map of a corrector: a drift whose affine column kicks
    the momentum of each row of ``kicks`` (1 for px, 3 for py) by its angle."""
    tm = drift_matrix(length, energy, species)
    return with_entries(tm, {(row, 6): angle for row, angle in kicks.items()})


def identity_transfer_map(energy: torch.Tensor) -> torch.Tensor:
    """The 7x7 identity, broadcast over the energy's vector dimensions."""
    eye = torch.eye(7, dtype=energy.dtype, device=energy.device)
    return eye.expand(*energy.shape, 7, 7)


def _rotation_entries(cs: torch.Tensor, sn: torch.Tensor) -> dict:
    return {
        (0, 0): cs,
        (0, 2): sn,
        (1, 1): cs,
        (1, 3): sn,
        (2, 0): -sn,
        (2, 2): cs,
        (3, 1): -sn,
        (3, 3): cs,
    }


def rotation_matrix(angle: torch.Tensor) -> torch.Tensor:
    """Coordinate rotation in the x-y plane."""
    return matrix7(
        _rotation_entries(torch.cos(angle), torch.sin(angle)), angle.shape, angle
    )


def misalignment_matrix(
    misalignment: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry/exit affine shifts for a transversely misaligned element."""
    vector_shape = misalignment.shape[:-1]
    mis_x, mis_y = misalignment[..., 0], misalignment[..., 1]
    R_entry = matrix7({(0, 6): -mis_x, (2, 6): -mis_y}, vector_shape, misalignment)
    R_exit = matrix7({(0, 6): mis_x, (2, 6): mis_y}, vector_shape, misalignment)
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

    rotation = _rotation_entries(cs, sn)
    tm_entry = matrix7(
        {**rotation, (0, 6): -mis_x * cs - mis_y * sn, (2, 6): mis_x * sn - mis_y * cs},
        vector_shape,
        cs,
    )
    transposed = {(column, row): value for (row, column), value in rotation.items()}
    tm_exit = matrix7({**transposed, (0, 6): mis_x, (2, 6): mis_y}, vector_shape, cs)
    return tm_entry, tm_exit


def quadrupole_matrix(
    length: torch.Tensor,
    k1: torch.Tensor,
    misalignment: torch.Tensor,
    tilt: torch.Tensor,
    energy: torch.Tensor,
    species: Species,
) -> torch.Tensor:
    """First-order map of a quadrupole: :func:`base_rmatrix` without
    curvature inside the frames of its misalignment and tilt,
    ``R_exit @ R @ R_entry``."""
    R = base_rmatrix(
        length=length, k1=k1, hx=torch.zeros_like(length), species=species, energy=energy
    )
    R_entry, R_exit = combined_rotation_misalignment_matrix(angle=tilt, misalignment=misalignment)
    return R_exit @ R @ R_entry


#: The ``(i, j, k)`` positions of the entries that :func:`base_ttensor` sets,
#: in the order of its list of values.
_TTENSOR_ENTRIES = (
    (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 0, 5), (0, 1, 5), (0, 5, 5), (0, 2, 2), (0, 2, 3),
    (0, 3, 3),
    (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 0, 5), (1, 1, 5), (1, 5, 5), (1, 2, 2), (1, 2, 3),
    (1, 3, 3),
    (2, 0, 2), (2, 0, 3), (2, 1, 2), (2, 1, 3), (2, 2, 5), (2, 3, 5),
    (3, 0, 2), (3, 0, 3), (3, 1, 2), (3, 1, 3), (3, 2, 5), (3, 3, 5),
    (4, 0, 0), (4, 0, 1), (4, 1, 1), (4, 0, 5), (4, 1, 5), (4, 5, 5), (4, 2, 2), (4, 2, 3),
    (4, 3, 3),
)  # fmt: skip


@constant_cache
def _ttensor_index(device: torch.device) -> torch.Tensor:
    return torch.tensor([49 * i + 7 * j + k for i, j, k in _TTENSOR_ENTRIES], device=device)


def base_ttensor(
    length: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    hx: torch.Tensor,
    species: Species,
    energy: torch.Tensor,
) -> torch.Tensor:
    """Second-order universal 7x7x7 T-tensor (MAD convention) for
    dipole/quadrupole/sextupole fields.

    :param length: Length of the element in m.
    :param k1: Quadrupole strength in 1/m^2.
    :param k2: Sextupole strength in 1/m^3.
    :param hx: Curvature (1/radius) of the element in 1/m.
    :param species: Particle species of the beam.
    :param energy: Beam energy in eV.
    """
    _, igamma2, beta = compute_relativistic_factors(energy, species.mass_eV)
    length, k1, k2, hx, igamma2, beta = torch.broadcast_tensors(
        length, k1, k2, hx, igamma2, beta
    )

    kx2 = k1 + torch.square(hx)
    ky2 = -k1
    L2 = torch.square(length)
    cx = cos_sqrt(kx2 * L2)
    cy = cos_sqrt(ky2 * L2)
    sx = sinc_sqrt(kx2 * L2) * length
    sy = sinc_sqrt(ky2 * L2) * length

    dx = 0.5 * L2 * torch.square(sinc_sqrt(0.25 * kx2 * L2))

    fx = length**3 * si1mdiv(kx2 * L2)
    f2y = length**3 * sicos1mdiv(ky2 * L2)

    j1 = fx
    j2 = length**3 * sipsicos3mdiv(kx2 * L2)
    # No singularity-free limit model exists for j3; a plain where-guard, as
    # in the JAX package.
    kx2_safe = torch.where(kx2 == 0, torch.ones_like(kx2), kx2)
    j3 = torch.where(
        kx2 == 0,
        length**7 / 56.0,
        (15.0 * length - 22.5 * sx + 9.0 * sx * cx - 1.5 * sx * torch.square(cx) + kx2 * sx**3)
        / (6.0 * kx2_safe**3),
    )
    j_denominator = kx2 - 4.0 * ky2
    jc = L2 * cossqrtmcosdivdiff(kx2 * L2, ky2 * L2)
    js = length**3 * simsidivdiff(kx2 * L2, ky2 * L2)
    jd = length**4 * si2msi2divdiff(kx2 * L2, ky2 * L2)
    j_denominator_safe = torch.where(
        j_denominator == 0, torch.ones_like(j_denominator), j_denominator
    )
    jf = torch.where(j_denominator == 0, length**5 / 120.0, (f2y - fx) / j_denominator_safe)

    khk = k2 + 2.0 * hx * k1
    beta2 = torch.square(beta)
    beta3 = beta2 * beta
    hx2 = torch.square(hx)
    dx2 = torch.square(dx)
    sx2 = torch.square(sx)

    values = [
        # (0, 0, 0) ... (0, 3, 3)
        -khk * (sx2 + dx) / 6.0 - 0.5 * hx * kx2 * sx2,
        2.0 * (-khk * sx * dx / 6.0 + 0.5 * hx * sx * cx),
        -khk * dx2 / 6.0 + 0.5 * hx * dx * cx,
        2.0
        * (
            -hx / 12.0 / beta * khk * (3.0 * sx * j1 - dx2)
            + 0.5 * hx2 / beta * sx2
            + 0.25 / beta * k1 * length * sx
        ),
        2.0
        * (
            -hx / 12.0 / beta * khk * (sx * dx2 - 2.0 * cx * j2)
            + 0.25 * hx2 / beta * (sx * dx + cx * j1)
            - 0.25 / beta * (sx + length * cx)
        ),
        -hx2 / 6.0 / beta2 * khk * (dx2 * dx - 2.0 * sx * j2)
        + 0.5 * hx**3 / beta2 * sx * j1
        - 0.5 * hx / beta2 * length * sx
        - 0.5 * hx / beta2 * igamma2 * dx,
        k1 * k2 * jd + 0.5 * (k2 + hx * k1) * dx,
        2.0 * (0.5 * k2 * js),
        k2 * jd - 0.5 * hx * dx,
        # (1, 0, 0) ... (1, 3, 3)
        -khk * sx * (1.0 + 2.0 * cx) / 6.0,
        -2.0 * khk * dx * (1.0 + 2.0 * cx) / 6.0,
        -khk * sx * dx / 3.0 - 0.5 * hx * sx,
        2.0
        * (
            -hx / 12.0 / beta * khk * (3.0 * cx * j1 + sx * dx)
            - 0.25 / beta * k1 * (sx - length * cx)
        ),
        2.0 * (-hx / 12.0 / beta * khk * (3.0 * sx * j1 + dx2) + 0.25 / beta * k1 * length * sx),
        -hx2 / 6.0 / beta2 * khk * (sx * dx2 - 2.0 * cx * j2)
        - 0.5 * hx / beta2 * k1 * (cx * j1 - sx * dx)
        - 0.5 * hx / beta2 * igamma2 * sx,
        k1 * k2 * js + 0.5 * (k2 + hx * k1) * sx,
        2.0 * (0.5 * k2 * jc),
        k2 * js - 0.5 * hx * sx,
        # (2, 0, 2) ... (2, 3, 5)
        2.0 * (0.5 * k2 * (cy * jc - 2.0 * k1 * sy * js) + 0.5 * hx * k1 * sx * sy),
        2.0 * (0.5 * k2 * (sy * jc - 2.0 * cy * js) + 0.5 * hx * sx * cy),
        2.0 * (0.5 * k2 * (cy * js - 2.0 * k1 * sy * jd) + 0.5 * hx * k1 * dx * sy),
        2.0 * (0.5 * k2 * (sy * js - 2.0 * cy * jd) + 0.5 * hx * dx * cy),
        2.0
        * (
            0.5 * hx / beta * k2 * (cy * jd - 2.0 * k1 * sy * jf)
            + 0.5 * hx2 / beta * k1 * j1 * sy
            - 0.25 / beta * k1 * length * sy
        ),
        2.0
        * (
            0.5 * hx / beta * k2 * (sy * jd - 2.0 * cy * jf)
            + 0.5 * hx2 / beta * j1 * cy
            - 0.25 / beta * (sy + length * cy)
        ),
        # (3, 0, 2) ... (3, 3, 5)
        2.0 * (0.5 * k1 * k2 * (2.0 * cy * js - sy * jc) + 0.5 * (k2 + hx * k1) * sx * cy),
        2.0 * (0.5 * k2 * (2.0 * k1 * sy * js - cy * jc) + 0.5 * (k2 + hx * k1) * sx * sy),
        2.0 * (0.5 * k1 * k2 * (2.0 * cy * jd - sy * js) + 0.5 * (k2 + hx * k1) * dx * cy),
        2.0 * (0.5 * k2 * (2.0 * k1 * sy * jd - cy * js) + 0.5 * (k2 + hx * k1) * dx * sy),
        2.0
        * (
            0.5 * hx / beta * k1 * k2 * (2.0 * cy * jf - sy * jd)
            + 0.5 * hx / beta * (k2 + hx * k1) * j1 * cy
            + 0.25 / beta * k1 * (sy - length * cy)
        ),
        2.0
        * (
            0.5 * hx / beta * k2 * (2.0 * k1 * sy * jf - cy * jd)
            + 0.5 * hx / beta * (k2 + hx * k1) * j1 * sy
            - 0.25 / beta * k1 * length * sy
        ),
        # (4, 0, 0) ... (4, 3, 3)
        -(hx / 12.0 / beta * khk * (sx * dx + 3.0 * j1) - 0.25 / beta * k1 * (length - sx * cx)),
        -2.0 * (hx / 12.0 / beta * khk * dx2 + 0.25 / beta * k1 * sx2),
        -(hx / 6.0 / beta * khk * j2 - 0.5 / beta * sx - 0.25 / beta * k1 * (j1 - sx * dx)),
        -2.0
        * (
            hx2 / 12.0 / beta2 * khk * (3.0 * dx * j1 - 4.0 * j2)
            + 0.25 * hx / beta2 * k1 * j1 * (1.0 + cx)
            + 0.5 * hx / beta2 * igamma2 * sx
        ),
        -2.0
        * (
            hx2 / 12.0 / beta2 * khk * (dx * dx2 - 2.0 * sx * j2)
            + 0.25 * hx / beta2 * k1 * sx * j1
            + 0.5 * hx / beta2 * igamma2 * dx
        ),
        -(
            hx**3 / 6.0 / beta3 * khk * (3.0 * j3 - 2.0 * dx * j2)
            + hx2 / 6.0 / beta3 * k1 * (sx * dx2 - j2 * (1.0 + 2.0 * cx))
            + 1.5 / beta3 * igamma2 * (hx2 * j1 - length)
        ),
        -(
            -hx / beta * k1 * k2 * jf
            - 0.5 * hx / beta * (k2 + hx * k1) * j1
            + 0.25 / beta * k1 * (length - cy * sy)
        ),
        -2.0 * (-0.5 * hx / beta * k2 * jd - 0.25 / beta * k1 * torch.square(sy)),
        -(-hx / beta * k2 * jf + 0.5 * hx2 / beta * j1 - 0.25 / beta * (length + cy * sy)),
    ]
    shape = length.shape
    T = length.new_zeros((*shape, 343)).index_copy(
        -1, _ttensor_index(length.device), torch.stack(values, dim=-1)
    )
    return T.reshape(*shape, 7, 7, 7)


def with_first_order(T: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``T`` with the first-order map ``R`` in its ``[..., :, 6, :]`` slice
    (the terms linear in the coordinates, as ``p_6 = 1``), where
    :func:`base_ttensor` leaves zeros; the two vector shapes broadcast."""
    shape = torch.broadcast_shapes(T.shape[:-3], R.shape[:-2])
    return torch.cat(
        [T.expand(*shape, 7, 7, 7)[..., :, :6, :], R.expand(*shape, 7, 7).unsqueeze(-2)],
        dim=-2,
    )
