"""Cloud-in-cell (CIC) charge deposition (counterpart of
``cheetah_tpu/ops/cloud_in_cell.py``).

A 3D grid (the space-charge kick's) goes to the CUDA kernels: positions
are mapped to bin space with the cell-centre convention of the JAX
package's ``_binspace_and_mask`` (``(pos - left) * nb / (right - left) -
0.5``); particles outside the extent lose their charge and are parked at -2,
where no corner lies on the grid, and get no gradient. The deposit itself is
:func:`cheetah_tpu_torch.ops.cic_kernels.differentiable_deposit`, whose
backward runs on the kernels too.

Any other dimension (the screen's 2D image, 1D profiles) takes the JAX
package's ``_deposit_scatter``: the cell-centre bin space ``(pos - left) /
((right - left) / nb) - 0.5``, charges outside the extent masked, each of
the ``2^d`` corners clamped to the grid and masked where it falls off it,
and one sum over ``batch * num_cells`` (:func:`fixed_point_index_add`,
which gives the same bits on every run, as the JAX package's
``segment_sum`` does, where a float ``index_add`` on CUDA adds in an order
that changes from run to run). Its gradient reaches the positions through
the corner fractions and the charges through the weights. The JAX
package's two other 2D deposits, the tensor-product matmul
(``_deposit_tensor_product``) and the bounding-box window
(``_deposit_tiled_2d``), compute the same function on the TPU's matrix
unit and are not carried over.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

from cheetah_tpu_torch.ops import cic_kernels
from cheetah_tpu_torch.utils.device import constant_cache
from cheetah_tpu_torch.utils.maths import presigned


def _fixed_point_sum(index: torch.Tensor, source: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros(size).index_add(0, index, source)`` summed as int64 fixed
    point: each finite value rounded to a multiple of 2^(floor(log2 S) -
    61), where S is the sum of the finite |source| (so that no sum passes
    2^62), the integers summed, the sums converted back once. A term rounds
    by at most S * 2^-62. Integer sums do not depend on their order, and
    the non-finite values, summed apart as floats among zeros, make their
    cells +inf, -inf or NaN whatever the order."""
    finite = torch.isfinite(source)
    magnitude = torch.where(finite, source, torch.zeros_like(source)).abs().double().sum()
    _, exponent = torch.frexp(magnitude)  # magnitude = m * 2^exponent, 0.5 <= m < 1
    scale = torch.where(magnitude > 0, torch.ldexp(torch.ones_like(magnitude), 62 - exponent),
                        torch.ones_like(magnitude))
    fixed = torch.round(torch.where(finite, source.double(), 0.0) * scale).to(torch.int64)
    sums = torch.zeros(size, dtype=torch.int64, device=source.device).index_add(0, index, fixed)
    poison = torch.zeros(size, dtype=source.dtype, device=source.device).index_add(
        0, index, torch.where(finite, torch.zeros_like(source), source)
    )
    return (sums.double() / scale).to(source.dtype) + poison


@presigned
class _FixedPointIndexAdd(torch.autograd.Function):
    """:func:`fixed_point_index_add` with the gradients of ``index_add``:
    the source's is the output's gradient at ``index``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(index, source, size):
        return _fixed_point_sum(index, source, size)

    @staticmethod
    def setup_context(ctx, inputs, output):
        index, _, size = inputs
        ctx.size = size
        ctx.save_for_backward(index)
        ctx.save_for_forward(index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return None, grad.index_select(0, index), None

    @staticmethod
    def jvp(ctx, index_dot, source_dot, size_dot):
        (index,) = ctx.saved_tensors
        return _fixed_point_sum(index, source_dot, ctx.size)


def fixed_point_index_add(index: torch.Tensor, source: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros(size).index_add(0, index, source)`` for 1-D ``index`` and
    ``source``, summed in int64 fixed point (``_fixed_point_sum``), so that
    the same inputs give the same bits on every run and device; differentiable
    in ``source``."""
    return _FixedPointIndexAdd.apply(index, source, size)



@constant_cache
def grid_counts(shape: tuple[int, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A grid's cell counts as a tensor on ``device``, made once: building it
    from the Python tuple on every call would copy it from the host, which a
    CUDA graph cannot capture."""
    return torch.tensor(shape, dtype=dtype, device=device)


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
    nb = grid_counts(tuple(histogram_shape), positions.dtype, positions.device)
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
    """Deposit particle charges onto a regular grid with multilinear (CIC)
    weights.

    :param positions: Particle positions of shape
        ``(..., num_particles, num_hist_dims)``.
    :param bins: Number of bins per dimension (int or sequence).
    :param extent: Grid extent of shape ``(..., num_hist_dims, 2)``
        (leftmost and rightmost bin edges). If ``None``, inferred from the
        positions. Particles outside the extent contribute no charge.
    :param charges: Particle charges of shape ``(..., num_particles)``;
        defaults to 1.
    :return: Charge grid of shape ``(..., *bins)``.
    """
    num_hist_dims = positions.shape[-1]
    histogram_shape = (
        [bins] * num_hist_dims if isinstance(bins, int) else [int(b) for b in bins]
    )
    if len(histogram_shape) != num_hist_dims:
        raise ValueError("Number of bin values must match number of position dimensions.")
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
    positions = positions.expand(*vector_shape, num_particles, num_hist_dims).reshape(
        -1, num_particles, num_hist_dims
    )
    extent = extent.expand(*vector_shape, num_hist_dims, 2).reshape(-1, num_hist_dims, 2)
    charges = charges.expand(*vector_shape, num_particles).reshape(-1, num_particles)
    if num_hist_dims != 3:
        grid = _deposit_scatter(positions, charges.to(positions.dtype), histogram_shape, extent)
        return grid.reshape(*vector_shape, *histogram_shape)

    parked, masked_charges = binspace_and_mask(
        positions, charges.to(positions.dtype), histogram_shape, extent
    )
    grid = cic_kernels.differentiable_deposit(
        parked, masked_charges[:, None, None, :], histogram_shape, cic_kernels.VALUE
    )
    return grid[:, 0].reshape(*vector_shape, *histogram_shape)


def _deposit_scatter(
    positions: torch.Tensor,
    charges: torch.Tensor,
    histogram_shape: list[int],
    extent: torch.Tensor,
) -> torch.Tensor:
    """CIC deposit as one sum over every instance's cells
    (:func:`fixed_point_index_add`).

    :param positions: ``(B, N, d)``.
    :param charges: ``(B, N)``.
    :param extent: ``(B, d, 2)``.
    :return: ``(B, *histogram_shape)``.
    """
    batch, _, num_hist_dims = positions.shape
    num_cells = math.prod(histogram_shape)
    in_extent = torch.ones_like(charges, dtype=torch.bool)
    int_components, frac_components = [], []
    for d in range(num_hist_dims):
        coord = positions[..., d]
        left = extent[:, d, 0][..., None]
        right = extent[:, d, 1][..., None]
        in_extent = in_extent & (coord >= left) & (coord <= right)
        in_bin_space = (coord - left) / ((right - left) / histogram_shape[d]) - 0.5
        int_part = torch.floor(in_bin_space)
        frac_components.append(in_bin_space - int_part)
        # Far-out and non-finite coordinates carry no charge; park them at
        # -2 so that their integer part stays in range. The masks select
        # rather than multiply, so a non-finite fraction adds nothing.
        int_components.append(
            torch.where(in_extent, int_part, torch.full_like(int_part, -2.0)).to(torch.int64)
        )
    masked_charges = torch.where(in_extent, charges, torch.zeros_like(charges))

    strides = [math.prod(histogram_shape[d + 1 :]) for d in range(num_hist_dims)]
    batch_offset = torch.arange(batch, device=positions.device)[:, None] * num_cells
    all_ids, all_weights = [], []
    for corner in itertools.product((0, 1), repeat=num_hist_dims):
        corner_idx = batch_offset
        corner_weight = masked_charges
        for d in range(num_hist_dims):
            idx = int_components[d] + corner[d]
            corner_idx = corner_idx + torch.clamp(idx, 0, histogram_shape[d] - 1) * strides[d]
            mask = (idx >= 0) & (idx < histogram_shape[d])
            factor = frac_components[d] if corner[d] else 1.0 - frac_components[d]
            corner_weight = corner_weight * torch.where(mask, factor, torch.zeros_like(factor))
        all_ids.append(corner_idx)
        all_weights.append(corner_weight)

    flat = fixed_point_index_add(torch.cat(all_ids, dim=-1).reshape(-1),
                                 torch.cat(all_weights, dim=-1).reshape(-1), batch * num_cells)
    return flat.reshape(batch, *histogram_shape)
