"""Evenly spaced values computed as the JAX package computes them
(counterpart of ``cheetah_tpu/utils/elementwise_linspace.py``).

``torch.linspace`` steps from both ends towards the middle. ``jnp.linspace``
computes ``start * (1 - t) + stop * t`` with ``t = i / (num - 1)``, and XLA
compiles that on the CPU to ``fma(i, stop * r, start * fma(-i, r, 1))``
with ``r = 1 / (num - 1)``, the last value set to ``stop``. The two differ
in the last bit of about half the values, so the port computes the XLA
form, with an error-free emulation of the fused multiply-add (PyTorch has
no such operation): the AREABSCR1 screen's pixel edges and centres then
equal the JAX package's bit for bit in float64. Where XLA's vector loop
leaves a remainder, it computes those few values without FMAs, and they
differ by one rounding.
"""

from __future__ import annotations

import torch


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a + b`` and its rounding error, exactly (Knuth)."""
    s = a + b
    b_virtual = s - a
    return s, (a - (s - b_virtual)) + (b - b_virtual)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low halves of ``a``'s mantissa (Veltkamp)."""
    factor = 134217729.0 if a.dtype == torch.float64 else 4097.0
    scaled = factor * a
    high = scaled - (scaled - a)
    return high, a - high


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding, from Dekker's exact product and
    Knuth's exact sum (the final sum of the two error terms rounds once
    more, which changes no value a screen's grid gives)."""
    product = a * b
    a_high, a_low = _split(a)
    b_high, b_low = _split(b)
    error = ((a_high * b_high - product) + a_high * b_low + a_low * b_high) + a_low * b_low
    total, rounding = _two_sum(product, c)
    return total + (rounding + error)


def linspace(
    start: torch.Tensor | float,
    stop: torch.Tensor | float,
    num: int,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``num`` evenly spaced values from ``start`` to ``stop`` along a new
    trailing axis, as ``jnp.linspace`` computes them on the CPU.

    :param start: Start values of shape ``(...)`` (a tensor keeps its dtype
        and device).
    :param stop: Stop values broadcastable against ``start``.
    :return: Tensor of shape ``(..., num)``.
    """
    if isinstance(start, torch.Tensor):
        dtype = dtype or start.dtype
        device = device or start.device
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=start.dtype, device=start.device)
    start, stop = torch.broadcast_tensors(start, stop)
    if num == 1:
        return start[..., None]
    div = num - 1
    index = torch.arange(div, dtype=start.dtype, device=start.device)
    reciprocal = torch.tensor(1.0 / div, dtype=start.dtype, device=start.device)
    one_minus_t = fma(-index, reciprocal, torch.ones_like(index))
    body = fma(index, (stop * reciprocal)[..., None], start[..., None] * one_minus_t)
    return torch.cat([body, stop[..., None]], dim=-1)


def elementwise_linspace(start: torch.Tensor, end: torch.Tensor, steps: int) -> torch.Tensor:
    """Linspace along a new trailing axis between broadcastable endpoints,
    ``start + (end - start) * linspace(0, 1, steps)``.

    :return: Tensor of shape ``(..., steps)``.
    """
    start, end = torch.broadcast_tensors(start, end)
    t = linspace(0.0, 1.0, steps, dtype=start.dtype, device=start.device)
    return start[..., None] + (end - start)[..., None] * t
