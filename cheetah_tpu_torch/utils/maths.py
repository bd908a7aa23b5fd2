"""Singularity-free compound expressions with custom derivatives.

Counterpart of the three functions of ``cheetah_tpu/utils/maths.py`` that
the first-order transfer map needs. Each removes a singularity at 0 with
``torch.where`` and a safe denominator, so neither branch produces a NaN.
The derivative rules of the JAX package (``jax.custom_jvp``,
``cheetah_tpu/utils/maths.py:187-250``) are ``torch.autograd.Function``s
here: autograd through ``sqrt(clamp(x))`` would give NaN at ``x = 0``, where
the rules give the analytic limits. Each backward is written with the
functions themselves, so second derivatives follow the same rules, as
``jax.grad`` of ``jax.grad`` does in the JAX package.
"""

from __future__ import annotations

import torch


def _safe(x: torch.Tensor, where_bad: torch.Tensor) -> torch.Tensor:
    """Replace entries where ``where_bad`` with 1 so they can be divided by."""
    return torch.where(where_bad, torch.ones_like(x), x)


def _cos_sqrt_value(x: torch.Tensor) -> torch.Tensor:
    xp = torch.sqrt(torch.clamp(x, min=0.0))
    xn = torch.sqrt(torch.clamp(-x, min=0.0))
    return torch.where(x >= 0, torch.cos(xp), torch.cosh(xn))


def _sinc_sqrt_value(x: torch.Tensor) -> torch.Tensor:
    xp = torch.sqrt(torch.clamp(x, min=0.0))
    xn = torch.sqrt(torch.clamp(-x, min=0.0))
    pos = torch.sin(xp) / _safe(xp, xp == 0)
    neg = torch.sinh(xn) / _safe(xn, xn == 0)
    return torch.where(x == 0, torch.ones_like(x), torch.where(x >= 0, pos, neg))


def _si1mdiv_value(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x == 0,
        torch.full_like(x, 1.0 / 6.0),
        (1.0 - _sinc_sqrt_value(x)) / _safe(x, x == 0),
    )


class _CosSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _cos_sqrt_value(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        # d/dx cos(sqrt(x)) = -si(sqrt(x)) / 2 (entire function, no singularity).
        return -0.5 * sinc_sqrt(x) * grad


class _SincSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sinc_sqrt_value(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return _dsinc_sqrt(x) * grad


class _Si1mdiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _si1mdiv_value(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        # f'(x) = (-si'(sqrt(x)) - f) / x with -si' = (si - cos)/(2x); limit -1/120.
        sx = (sinc_sqrt(x) - cos_sqrt(x)) / (2.0 * _safe(x, x == 0))
        slope = torch.where(
            x == 0, torch.full_like(x, -1.0 / 120.0), (sx - si1mdiv(x)) / _safe(x, x == 0)
        )
        return slope * grad


def _dsinc_sqrt(x: torch.Tensor) -> torch.Tensor:
    """d/dx si(sqrt(x)) = (cos(sqrt(x)) - si(sqrt(x))) / (2x); limit -1/6."""
    return torch.where(
        x == 0,
        torch.full_like(x, -1.0 / 6.0),
        (cos_sqrt(x) - sinc_sqrt(x)) / (2.0 * _safe(x, x == 0)),
    )


def cos_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``cos(sqrt(x))`` extended evenly to negative ``x`` via ``cosh(sqrt(-x))``."""
    return _CosSqrt.apply(x)


def sinc_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sin(sqrt(x))/sqrt(x)``, evenly extended; 1 at ``x = 0``."""
    return _SincSqrt.apply(x)


def si1mdiv(x: torch.Tensor) -> torch.Tensor:
    """``(1 - sinc_sqrt(x)) / x`` with limit 1/6 at 0."""
    return _Si1mdiv.apply(x)
