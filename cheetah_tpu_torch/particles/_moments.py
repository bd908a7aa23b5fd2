"""Helpers for assembling beam moments from named parameters (counterpart of
``cheetah_tpu/particles/_moments.py``)."""

from __future__ import annotations

import torch

from cheetah_tpu_torch.utils.device import as_float_tensor

PARAMETER_DEFAULTS = {
    "mu_x": 0.0,
    "mu_px": 0.0,
    "mu_y": 0.0,
    "mu_py": 0.0,
    "mu_tau": 0.0,
    "mu_p": 0.0,
    "sigma_x": 175e-6,
    "sigma_px": 4e-6,
    "sigma_y": 175e-6,
    "sigma_py": 4e-6,
    "sigma_tau": 8e-6,
    "sigma_p": 2e-3,
    "cov_xpx": 0.0,
    "cov_ypy": 0.0,
    "cov_taup": 0.0,
    "cov_xp": 0.0,
    "cov_pxp": 0.0,
    "cov_yp": 0.0,
    "cov_pyp": 0.0,
    "cov_xy": 0.0,
    "cov_xpy": 0.0,
    "cov_xtau": 0.0,
    "cov_pxy": 0.0,
    "cov_pxpy": 0.0,
    "cov_pxtau": 0.0,
    "cov_ytau": 0.0,
    "cov_pytau": 0.0,
}

# (row, col) of each named covariance entry in the 6x6 matrix.
_COV_POSITIONS = {
    "cov_xpx": (0, 1),
    "cov_ypy": (2, 3),
    "cov_taup": (4, 5),
    "cov_xp": (0, 5),
    "cov_pxp": (1, 5),
    "cov_yp": (2, 5),
    "cov_pyp": (3, 5),
    "cov_xy": (0, 2),
    "cov_xpy": (0, 3),
    "cov_xtau": (0, 4),
    "cov_pxy": (1, 2),
    "cov_pxpy": (1, 3),
    "cov_pxtau": (1, 4),
    "cov_ytau": (2, 4),
    "cov_pytau": (3, 4),
}

_SIGMA_NAMES = ["sigma_x", "sigma_px", "sigma_y", "sigma_py", "sigma_tau", "sigma_p"]


def resolve_parameters(
    dtype: torch.dtype, device: torch.device, **overrides
) -> dict[str, torch.Tensor]:
    """Fill in defaults and convert all beam parameters to tensors.

    Unknown names raise, so a misspelt ``sigma_xq`` cannot silently give a
    default beam."""
    unknown = sorted(set(overrides) - set(PARAMETER_DEFAULTS))
    if unknown:
        raise TypeError(
            f"Unknown beam moment parameter(s) {unknown}; valid names are "
            f"{sorted(PARAMETER_DEFAULTS)}"
        )
    resolved = {}
    for name, default in PARAMETER_DEFAULTS.items():
        value = overrides.get(name)
        resolved[name] = as_float_tensor(
            value if value is not None else default, dtype=dtype, device=device
        )
    return resolved


def build_mu(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack the six means into a broadcast ``(..., 6)`` vector."""
    names = ["mu_x", "mu_px", "mu_y", "mu_py", "mu_tau", "mu_p"]
    return torch.stack(torch.broadcast_tensors(*(params[n] for n in names)), dim=-1)


def build_cov(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Assemble the ``(..., 6, 6)`` covariance matrix from named entries."""
    entries = torch.broadcast_tensors(
        *(params[name] for name in _SIGMA_NAMES), *(params[k] for k in _COV_POSITIONS)
    )
    sigmas = entries[: len(_SIGMA_NAMES)]
    cov = torch.zeros(
        (*sigmas[0].shape, 6, 6), dtype=sigmas[0].dtype, device=sigmas[0].device
    )
    for i in range(6):
        cov[..., i, i] = torch.square(sigmas[i])
    for (i, j), value in zip(_COV_POSITIONS.values(), entries[len(_SIGMA_NAMES):]):
        cov[..., i, j] = value
        cov[..., j, i] = value
    return cov


def twiss_to_parameters(
    beta_x: torch.Tensor,
    alpha_x: torch.Tensor,
    emittance_x: torch.Tensor,
    beta_y: torch.Tensor,
    alpha_y: torch.Tensor,
    emittance_y: torch.Tensor,
    sigma_p: torch.Tensor,
    dispersion_x: torch.Tensor,
    dispersion_px: torch.Tensor,
    dispersion_y: torch.Tensor,
    dispersion_py: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Twiss parameters to second moments."""
    sigma_p2 = torch.square(sigma_p)
    return {
        "sigma_x": torch.sqrt(emittance_x * beta_x + torch.square(dispersion_x) * sigma_p2),
        "sigma_px": torch.sqrt(
            emittance_x * (1 + torch.square(alpha_x)) / beta_x
            + torch.square(dispersion_px) * sigma_p2
        ),
        "sigma_y": torch.sqrt(emittance_y * beta_y + torch.square(dispersion_y) * sigma_p2),
        "sigma_py": torch.sqrt(
            emittance_y * (1 + torch.square(alpha_y)) / beta_y
            + torch.square(dispersion_py) * sigma_p2
        ),
        "cov_xpx": -emittance_x * alpha_x + dispersion_x * dispersion_px * sigma_p2,
        "cov_ypy": -emittance_y * alpha_y + dispersion_y * dispersion_py * sigma_p2,
        "cov_xp": dispersion_x * sigma_p2,
        "cov_pxp": dispersion_px * sigma_p2,
        "cov_yp": dispersion_y * sigma_p2,
        "cov_pyp": dispersion_py * sigma_p2,
    }
