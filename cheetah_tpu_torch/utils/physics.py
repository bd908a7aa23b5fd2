"""Relativistic kinematics helpers (counterpart of ``cheetah_tpu/utils/physics.py``)."""

from __future__ import annotations

import torch


def compute_relativistic_factors(
    energy: torch.Tensor, particle_mass_eV: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute (gamma, 1/gamma^2, beta) for a reference energy in eV."""
    gamma = energy / particle_mass_eV
    igamma2 = 1.0 / torch.square(gamma)
    beta = torch.sqrt(1.0 - igamma2)
    return gamma, igamma2, beta
