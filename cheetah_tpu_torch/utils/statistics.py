"""Weighted statistics and exact moment matching.

Counterpart of ``cheetah_tpu/utils/statistics.py``. All functions reduce over
the particle axis and broadcast over leading vector dimensions.
"""

from __future__ import annotations

import torch


def unbiased_weighted_covariance(
    inputs1: torch.Tensor, inputs2: torch.Tensor, weights: torch.Tensor, dim: int = -1
) -> torch.Tensor:
    """Unbiased weighted covariance of two samples along ``dim``."""
    total_weight = torch.sum(weights, dim=dim)
    mean1 = torch.sum(inputs1 * weights, dim=dim) / total_weight
    mean2 = torch.sum(inputs2 * weights, dim=dim) / total_weight
    correction = total_weight - torch.sum(torch.square(weights), dim=dim) / total_weight
    centered = (inputs1 - mean1.unsqueeze(dim)) * (inputs2 - mean2.unsqueeze(dim))
    return torch.sum(weights * centered, dim=dim) / correction


def unbiased_weighted_variance(
    inputs: torch.Tensor, weights: torch.Tensor, dim: int = -1
) -> torch.Tensor:
    """Unbiased weighted variance along ``dim``."""
    return unbiased_weighted_covariance(inputs, inputs, weights, dim=dim)


def unbiased_weighted_std(
    inputs: torch.Tensor, weights: torch.Tensor, dim: int = -1
) -> torch.Tensor:
    """Unbiased weighted standard deviation along ``dim``."""
    return torch.sqrt(unbiased_weighted_variance(inputs, weights, dim=dim))


def unbiased_weighted_covariance_matrix(
    inputs: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Unbiased weighted covariance matrix.

    :param inputs: Samples of shape ``(..., num_samples, num_features)``.
    :param weights: Weights of shape ``(..., num_samples)``.
    :return: Covariance matrix of shape ``(..., num_features, num_features)``.
    """
    normalized = weights / torch.sum(weights, dim=-1, keepdim=True)
    correction = 1.0 - torch.sum(torch.square(normalized), dim=-1)
    means = torch.sum(inputs * normalized[..., None], dim=-2, keepdim=True)
    centered = inputs - means
    cov = torch.matmul((normalized[..., None] * centered).transpose(-1, -2), centered)
    return cov / correction[..., None, None]


def match_distribution_moments(
    samples: torch.Tensor,
    target_mu: torch.Tensor,
    target_cov: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Affinely transform ``samples`` to have *exactly* the target moments.

    Whiten with the inverse Cholesky factor of the sample covariance, then
    recolour with the Cholesky factor of the target covariance.

    :param samples: Samples of shape ``(..., num_samples, num_features)``.
    :param target_mu: Target mean of shape ``(..., num_features)``.
    :param target_cov: Target covariance of shape ``(..., num_features,
        num_features)``.
    :param weights: Optional sample weights of shape ``(..., num_samples)``.
    """
    num_features = samples.shape[-1]
    if weights is None:
        weights = torch.ones_like(samples[..., 0])
    sample_cov = unbiased_weighted_covariance_matrix(samples, weights)
    sample_mu = torch.sum(samples * weights[..., None], dim=-2) / torch.sum(
        weights, dim=-1, keepdim=True
    )

    chol_sample = torch.linalg.cholesky(sample_cov)
    eye = torch.eye(num_features, dtype=samples.dtype, device=samples.device)
    inv_sqrt_sample = torch.linalg.solve_triangular(
        chol_sample, eye.expand(chol_sample.shape), upper=False
    )
    chol_target = torch.linalg.cholesky(target_cov)

    vector_shape = torch.broadcast_shapes(target_mu.shape[:-1], target_cov.shape[:-2])
    transform = torch.matmul(
        chol_target,
        inv_sqrt_sample.expand(*vector_shape, num_features, num_features),
    ).transpose(-1, -2)
    centered = samples - sample_mu[..., None, :]
    return torch.matmul(centered, transform) + target_mu[..., None, :]
