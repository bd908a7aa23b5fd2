"""Cloud-in-cell (CIC) charge deposition on a 3D grid (counterpart of the 3D
case of ``cheetah_tpu/ops/cloud_in_cell.py``).

Positions are mapped to bin space with the cell-centre convention of the
JAX package's ``_binspace_and_mask`` (``(pos - left) * nb / (right - left) -
0.5``); particles outside the extent lose their charge and are parked at -2,
where no corner lies on the grid, and get no gradient. The deposit itself is
:func:`cheetah_tpu_torch.ops.cic_kernels.differentiable_deposit`, whose
backward runs on the kernels too.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cheetah_tpu_torch.ops import cic_kernels


def binspace_and_mask(
    positions: torch.Tensor,
    charges: torch.Tensor,
    histogram_shape: Sequence[int],
    extent: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bin-space positions and extent-masked charges.

    :param positions: ``(B, N, 3)``.
    :param charges: ``(B, N)``.
    :param extent: ``(B, 3, 2)``, the left and right grid edges per axis.
    :return: Parked bin-space positions ``(B, N, 3)`` and masked charges
        ``(B, N)``.
    """
    left = extent[:, None, :, 0]
    right = extent[:, None, :, 1]
    nb = torch.as_tensor(histogram_shape, dtype=positions.dtype, device=positions.device)
    scale = nb / (right - left)
    in_bin_space = (positions - left) * scale - 0.5
    in_extent = torch.all((positions >= left) & (positions <= right), dim=-1)
    masked_charges = charges * in_extent
    parked = torch.where(
        in_extent[..., None], in_bin_space, torch.full_like(in_bin_space, -2.0)
    )
    return parked, masked_charges


def cloud_in_cell_charge_deposition(
    positions: torch.Tensor,
    bins: int | Sequence[int],
    extent: torch.Tensor | None = None,
    charges: torch.Tensor | None = None,
) -> torch.Tensor:
    """Deposit particle charges onto a regular 3D grid with trilinear (CIC)
    weights.

    :param positions: Particle positions of shape ``(..., num_particles, 3)``.
    :param bins: Number of bins per dimension (int or sequence of three).
    :param extent: Grid extent of shape ``(..., 3, 2)`` (leftmost and
        rightmost bin edges). If ``None``, inferred from the positions.
        Particles outside the extent contribute no charge.
    :param charges: Particle charges of shape ``(..., num_particles)``;
        defaults to 1.
    :return: Charge grid of shape ``(..., *bins)``.
    """
    num_hist_dims = positions.shape[-1]
    if num_hist_dims != 3:
        raise NotImplementedError(
            "Only the 3D deposit is ported so far; the 1D and 2D deposits come "
            "with the diagnostics slice."
        )
    histogram_shape = [bins] * 3 if isinstance(bins, int) else [int(b) for b in bins]
    if extent is None:
        extent = torch.stack(
            [positions.amin(dim=-2), positions.amax(dim=-2)], dim=-1
        )
    if charges is None:
        charges = torch.ones_like(positions[..., 0])

    vector_shape = torch.broadcast_shapes(
        positions.shape[:-2], extent.shape[:-2], charges.shape[:-1]
    )
    num_particles = positions.shape[-2]
    positions = positions.expand(*vector_shape, num_particles, 3).reshape(
        -1, num_particles, 3
    )
    extent = extent.expand(*vector_shape, 3, 2).reshape(-1, 3, 2)
    charges = charges.expand(*vector_shape, num_particles).reshape(-1, num_particles)

    parked, masked_charges = binspace_and_mask(
        positions, charges.to(positions.dtype), histogram_shape, extent
    )
    grid = cic_kernels.differentiable_deposit(
        parked, masked_charges[:, None, None, :], histogram_shape, cic_kernels.VALUE
    )
    return grid[:, 0].reshape(*vector_shape, *histogram_shape)
