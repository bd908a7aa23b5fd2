"""A frozen plain copy of the space-charge kick with its cloud-in-cell
deposit and gather.

The kick is Cheetah's integrated-Green-function (Hockney) solver in the lab
frame with a gamma-scaled longitudinal coordinate:

1. the particles go to SI coordinates ``(x, p_x, y, p_y, z, p_z, 1)``;
2. their charge is deposited onto a grid of ``grid_shape`` cells spanning
   ``+-3`` standard deviations of ``x``, ``y`` and ``tau``, with cell-centre
   bins (``(pos - left) / cell - 0.5``); a particle outside the extent
   deposits nothing;
3. the density, zero-padded to twice the grid, is convolved with the
   tabulated integrated Green function by FFT;
4. the potential's central differences, zero on the boundary planes and
   scaled by ``-1 / gamma^2``, are the force fields;
5. the fields are gathered to the particles at node positions
   (``(pos + extent) / cell``) and kick the momenta by ``F e dt``.

The cloud-in-cell weights are the trilinear hat functions: corner
``floor(p)`` weighs ``1 - f`` and ``floor(p) + 1`` weighs ``f`` on each axis,
and a corner off the grid weighs 0. Plain autograd differentiates all of it.
"""

from __future__ import annotations

import itertools
import math

import torch
from scipy.constants import physical_constants

from portbench.reference.optics import ELECTRON_MASS_KG, relativistic, sigma

SPEED_OF_LIGHT = physical_constants["speed of light in vacuum"][0]
ELEMENTARY_CHARGE = physical_constants["elementary charge"][0]
EPSILON_0 = physical_constants["vacuum electric permittivity"][0]
#: Half-extent of the grid in standard deviations, on every axis.
GRID_EXTENT = 3.0


def _corners(positions: torch.Tensor, shape: tuple[int, int, int]):
    """Each of the 8 corners: flat cell index, validity and weight."""
    base = torch.floor(positions)
    frac = positions - base
    finite = torch.isfinite(positions).all(dim=-1)
    base = torch.where(torch.isfinite(base), base, torch.zeros_like(base)).long()
    strides = (shape[1] * shape[2], shape[2], 1)
    for corner in itertools.product((0, 1), repeat=3):
        index = torch.zeros_like(base[..., 0])
        valid = finite
        weight = torch.ones_like(frac[..., 0])
        for axis, offset in enumerate(corner):
            cell = base[..., axis] + offset
            valid = valid & (cell >= 0) & (cell < shape[axis])
            index = index + cell.clamp(0, shape[axis] - 1) * strides[axis]
            weight = weight * (frac[..., axis] if offset else 1.0 - frac[..., axis])
        yield index, valid, weight


def cic_deposit(positions: torch.Tensor, charges: torch.Tensor, shape) -> torch.Tensor:
    """Charges ``(N,)`` at bin-space ``positions (N, 3)`` onto a grid."""
    grid = torch.zeros(math.prod(shape), dtype=charges.dtype, device=charges.device)
    for index, valid, weight in _corners(positions, shape):
        grid = grid.index_add(0, index, torch.where(valid, weight * charges, 0.0))
    return grid.view(shape)


def cic_gather(grids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Grids ``(C, nx, ny, nt)`` at bin-space ``positions (N, 3)``: ``(C, N)``."""
    shape = tuple(grids.shape[1:])
    flat = grids.reshape(grids.shape[0], -1)
    out = torch.zeros(grids.shape[0], positions.shape[0], dtype=grids.dtype, device=grids.device)
    for index, valid, weight in _corners(positions, shape):
        out = out + torch.where(valid, weight, 0.0) * flat[:, index]
    return out


def _integrated_potential(x, y, tau):
    r = torch.sqrt(x * x + y * y + tau * tau)
    return (
        -0.5 * tau * tau * torch.arctan(x * y / (tau * r))
        - 0.5 * y * y * torch.arctan(x * tau / (y * r))
        - 0.5 * x * x * torch.arctan(y * tau / (x * r))
        + y * tau * torch.asinh(x / torch.sqrt(y * y + tau * tau))
        + x * tau * torch.asinh(y / torch.sqrt(x * x + tau * tau))
        + x * y * torch.asinh(tau / torch.sqrt(x * x + y * y))
    )


def green_function(gamma: float, cell: torch.Tensor, shape) -> torch.Tensor:
    """The integrated Green function on the doubled grid (Hockney's layout
    on each axis: the table, a zero plane, the table mirrored)."""
    dx, dy, dt = cell[0], cell[1], cell[2] * gamma

    def corners(n):
        return torch.arange(n + 1, dtype=cell.dtype, device=cell.device) - 0.5

    ix, iy, it = torch.meshgrid(corners(shape[0]), corners(shape[1]), corners(shape[2]),
                                indexing="ij")
    phi = _integrated_potential(ix * dx, iy * dy, it * dt)
    lo, hi = slice(None, -1), slice(1, None)
    table = (phi[hi, hi, hi] - phi[lo, hi, hi] - phi[hi, lo, hi] - phi[hi, hi, lo]
             + phi[hi, lo, lo] + phi[lo, hi, lo] + phi[lo, lo, hi] - phi[lo, lo, lo])
    for dim in range(3):
        zero_shape = list(table.shape)
        zero_shape[dim] = 1
        body = torch.flip(table.narrow(dim, 1, table.shape[dim] - 1), (dim,))
        table = torch.cat([table, table.new_zeros(zero_shape), body], dim)
    return table


def kick(particles: torch.Tensor, energy: float, charges: torch.Tensor,
         effect_length: torch.Tensor, shape) -> torch.Tensor:
    """Particles ``(N, 7)`` after a space-charge kick over ``effect_length``."""
    shape = tuple(int(n) for n in shape)
    gamma0, igamma2, beta0 = relativistic(energy)
    p0 = gamma0 * beta0 * ELECTRON_MASS_KG * SPEED_OF_LIGHT
    x, px, y, py, tau, p = (particles[:, i] for i in range(6))
    gamma = gamma0 * (1.0 + p * beta0)
    rel = gamma * torch.sqrt(1.0 - 1.0 / (gamma * gamma)) / (gamma0 * beta0)
    pz = p0 * torch.sqrt(rel * rel - px * px - py * py)
    positions = torch.stack([x, y, -beta0 * tau], dim=-1)

    extent = GRID_EXTENT * torch.stack([sigma(x), sigma(y), sigma(tau)])
    counts = torch.tensor(shape, dtype=particles.dtype, device=particles.device)
    cell = 2 * extent / counts
    inside = ((positions >= -extent) & (positions <= extent)).all(dim=-1)
    bins = torch.where(inside[:, None], (positions + extent) / cell - 0.5, -2.0)
    grid = cic_deposit(bins, torch.where(inside, charges, 0.0), shape)
    density = torch.nn.functional.pad(grid / (cell[0] * cell[1] * cell[2]),
                                      (0, shape[2], 0, shape[1], 0, shape[0]))
    green = green_function(gamma0, cell, shape)
    potential = torch.fft.irfftn(torch.fft.rfftn(density) * torch.fft.rfftn(green),
                                 s=density.shape)[: shape[0], : shape[1], : shape[2]]
    potential = potential / (4 * math.pi * EPSILON_0)

    fields = []
    for axis in range(3):
        difference = (torch.roll(potential, -1, axis) - torch.roll(potential, 1, axis)) / (
            2 * cell[axis])
        index = torch.arange(shape[axis], device=particles.device)
        interior = ((index > 0) & (index < shape[axis] - 1)).view(
            [-1 if d == axis else 1 for d in range(3)])
        fields.append(-igamma2 * difference * interior)
    forces = cic_gather(torch.stack(fields), (positions + extent) / cell) * ELEMENTARY_CHARGE
    dt = effect_length / (SPEED_OF_LIGHT * beta0)

    px_si = px * p0 + forces[0] * dt
    py_si = py * p0 + forces[1] * dt
    pz = pz + forces[2] * dt
    px_rel, py_rel, pz_rel = px_si / p0, py_si / p0, pz / p0
    p_rel = torch.sqrt(px_rel * px_rel + py_rel * py_rel + pz_rel * pz_rel)
    gamma = torch.sqrt(1.0 + (p_rel * gamma0 * beta0) ** 2)
    return torch.stack([x, px_rel, y, py_rel, tau, (gamma - gamma0) / (beta0 * gamma0),
                        particles[:, 6]], dim=-1)
