"""Differentiable Gaussian-KDE histograms (counterpart of
``cheetah_tpu/utils/kde.py``).

The joint 2D pdf is a batched matmul of per-dimension kernel-value matrices
(``K1^T @ K2``), accumulated over chunks of particles so that the kernel
matrices stay ``O(chunk_size x num_bins)`` (about 1 GB each for 100k
particles on a 2448-pixel axis if made at once).
"""

from __future__ import annotations

import math

import torch


def _kde_marginal_pdf(
    values: torch.Tensor,
    bins: torch.Tensor,
    sigma: torch.Tensor,
    weights: torch.Tensor | None = None,
    epsilon: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension KDE kernel values and marginal pdf.

    :param values: Samples of shape ``(..., N)``.
    :param bins: Bin centres of shape ``(num_bins,)``.
    :param sigma: Gaussian bandwidth (scalar).
    :param weights: Optional sample weights of shape ``(..., N)``.
    :return: ``(pdf (..., num_bins), kernel_values (..., N, num_bins))``.
    """
    values = values[..., None]
    weights = torch.ones_like(values) if weights is None else weights[..., None]
    residuals = values - bins
    kernel_values = (
        weights
        * torch.exp(-0.5 * torch.square(residuals / sigma))
        / torch.sqrt(2 * math.pi * torch.square(sigma))
    )
    clamped = torch.clamp(kernel_values, min=torch.finfo(kernel_values.dtype).tiny)
    probability_mass = torch.sum(clamped, dim=-2)
    normalization = torch.sum(probability_mass, dim=-1, keepdim=True) + epsilon
    return probability_mass / normalization, clamped


def kde_histogram_1d(
    x: torch.Tensor,
    bins: torch.Tensor,
    bandwidth: torch.Tensor,
    weights: torch.Tensor | None = None,
    epsilon: float = 1e-10,
) -> torch.Tensor:
    """Differentiable 1D histogram via KDE, of shape ``(..., num_bins)``."""
    pdf, _ = _kde_marginal_pdf(x, bins, bandwidth, weights, epsilon)
    return pdf


def kde_histogram_2d(
    x1: torch.Tensor,
    x2: torch.Tensor,
    bins1: torch.Tensor,
    bins2: torch.Tensor,
    bandwidth: torch.Tensor,
    weights: torch.Tensor | None = None,
    epsilon: float = 1e-10,
    chunk_size: int = 4096,
    window: int | None = None,
) -> torch.Tensor:
    """Differentiable 2D histogram via KDE.

    ``window`` (opt-in) evaluates the kernels only on a ``window``-bins
    bounding box around the samples, with a 10-bandwidth margin (kernel
    tails below ``exp(-50)`` of peak are left out), and places the result
    in the full grid. Where the samples and margin span more than the
    window, the full evaluation runs instead: one host synchronisation
    chooses between the two evaluations (:func:`window_placement`). The
    window needs uniformly spaced bins and unbatched samples, and is
    ignored otherwise.

    :param x1: Samples of the first dimension, shape ``(..., N)``.
    :param x2: Samples of the second dimension, shape ``(..., N)``.
    :param weights: Optional sample weights of shape ``(..., N)``.
    :return: Joint pdf of shape ``(..., num_bins1, num_bins2)``.
    """
    if (
        window is not None
        and x1.ndim == 1
        and window < bins1.shape[0]
        and window < bins2.shape[0]
        and bins_uniform(bins1)
        and bins_uniform(bins2)
    ):
        offset1, offset2, fits = window_placement(x1, x2, bins1, bins2, bandwidth, window)
        if fits:
            joint = kde_histogram_2d(
                x1, x2, bins1[offset1 : offset1 + window], bins2[offset2 : offset2 + window],
                bandwidth, weights, epsilon=epsilon, chunk_size=chunk_size,
            )
            return torch.nn.functional.pad(
                joint,
                (offset2, bins2.shape[0] - offset2 - window,
                 offset1, bins1.shape[0] - offset1 - window),
            )

    num_particles = x1.shape[-1]
    joint = None
    for start in range(0, num_particles, chunk_size):
        chunk = slice(start, start + chunk_size)
        _, k1 = _kde_marginal_pdf(
            x1[..., chunk], bins1, bandwidth, None if weights is None else weights[..., chunk]
        )
        _, k2 = _kde_marginal_pdf(x2[..., chunk], bins2, bandwidth, None)
        term = k1.transpose(-1, -2) @ k2
        joint = term if joint is None else joint + term
    normalization = torch.sum(joint, dim=(-2, -1))[..., None, None] + epsilon
    return joint / normalization


def bins_uniform(bins: torch.Tensor) -> bool:
    """Whether the bins are evenly spaced up to the rounding of their dtype
    (one host copy of the bins).

    The JAX package asks for steps equal to rtol 1e-9, which float32 bins
    of a megapixel screen never meet (their steps differ by rounding, ~1e-4
    of a step), so its float32 screens always take the full evaluation. The
    port allows 16 ulps of the largest bin besides, which keeps float64
    bins to the JAX package's test and lets float32 bins use the window.
    """
    if bins.shape[0] < 2:
        return False
    host = bins.detach().cpu().double()
    steps = host[1:] - host[:-1]
    tolerance = 1e-9 * steps[0].abs() + 16 * torch.finfo(bins.dtype).eps * host.abs().max()
    return bool(torch.all((steps - steps[0]).abs() <= tolerance))


def window_placement(
    x1: torch.Tensor,
    x2: torch.Tensor,
    bins1: torch.Tensor,
    bins2: torch.Tensor,
    bandwidth: torch.Tensor,
    window: int,
) -> tuple[int, int, bool]:
    """Where the ``window`` x ``window`` bins go, and whether the samples
    plus a 10-bandwidth margin fit them.

    Per axis, the samples' bounding box in bin space (clipped to the grid,
    so off-grid samples reach only edge bins) widened by the margin, itself
    clipped to the grid on both sides; the window starts at its low end,
    moved inwards where it would pass the grid's border.

    :return: ``(offset1, offset2, fits)``, read with one host copy.
    """

    def axis_window(x: torch.Tensor, bins: torch.Tensor) -> tuple[torch.Tensor, ...]:
        num_bins = bins.shape[0]
        step = bins[1] - bins[0]
        margin = torch.ceil(10.0 * bandwidth / step).to(torch.int64)
        s = torch.clamp((x - bins[0]) / step, 0.0, num_bins - 1.0)
        lo = torch.floor(torch.min(s)).to(torch.int64) - margin
        hi = torch.clamp(torch.ceil(torch.max(s)).to(torch.int64) + margin, max=num_bins - 1)
        offset = torch.clamp(lo, 0, num_bins - window)
        return offset, hi - offset <= window - 1

    with torch.no_grad():
        offset1, fits1 = axis_window(x1, bins1)
        offset2, fits2 = axis_window(x2, bins2)
        offset1, offset2, fits = torch.stack(
            [offset1, offset2, (fits1 & fits2).to(torch.int64)]
        ).tolist()
    return offset1, offset2, bool(fits)
