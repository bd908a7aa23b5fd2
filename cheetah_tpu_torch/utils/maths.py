"""Singularity-free compound expressions (forward values).

Counterpart of the three functions of ``cheetah_tpu/utils/maths.py`` that
the first-order transfer map needs. Each removes a singularity at 0 with
``torch.where`` and a safe denominator, so neither branch produces a NaN.
The custom derivative rules of the JAX package (``jax.custom_jvp``) become
``torch.autograd.Function``s in the gradient slice of the port.
"""

from __future__ import annotations

import torch


def _safe(x: torch.Tensor, where_bad: torch.Tensor) -> torch.Tensor:
    """Replace entries where ``where_bad`` with 1 so they can be divided by."""
    return torch.where(where_bad, torch.ones_like(x), x)


def cos_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``cos(sqrt(x))`` extended evenly to negative ``x`` via ``cosh(sqrt(-x))``."""
    xp = torch.sqrt(torch.clamp(x, min=0.0))
    xn = torch.sqrt(torch.clamp(-x, min=0.0))
    return torch.where(x >= 0, torch.cos(xp), torch.cosh(xn))


def sinc_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sin(sqrt(x))/sqrt(x)``, evenly extended; 1 at ``x = 0``."""
    xp = torch.sqrt(torch.clamp(x, min=0.0))
    xn = torch.sqrt(torch.clamp(-x, min=0.0))
    pos = torch.sin(xp) / _safe(xp, xp == 0)
    neg = torch.sinh(xn) / _safe(xn, xn == 0)
    return torch.where(x == 0, torch.ones_like(x), torch.where(x >= 0, pos, neg))


def si1mdiv(x: torch.Tensor) -> torch.Tensor:
    """``(1 - sinc_sqrt(x)) / x`` with limit 1/6 at 0."""
    return torch.where(
        x == 0,
        torch.full_like(x, 1.0 / 6.0),
        (1.0 - sinc_sqrt(x)) / _safe(x, x == 0),
    )
