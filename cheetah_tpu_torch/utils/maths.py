"""Singularity-free compound expressions with custom derivatives.

Counterpart of ``cheetah_tpu/utils/maths.py``. Each function removes a
singularity at 0 (or at ``a == b``) with ``torch.where`` and a safe
denominator, so neither branch produces a NaN. The derivative rules of the
JAX package (``jax.custom_jvp``) are ``torch.autograd.Function``s here:
autograd through ``sqrt(clamp(x))`` would give NaN at ``x = 0``, where the
rules give the analytic limits.

Every Function is written in the form that ``torch.func`` transforms:
``forward`` without ``ctx``, a ``setup_context``, a ``backward`` and a
``jvp`` (so ``torch.func.grad``, ``jvp``, ``jacfwd``, ``hessian`` and
``torch.autograd.forward_ad`` apply), and ``generate_vmap_rule = True``,
which is sound because every forward is plain torch ops. The derivative
rules are written with the Functions themselves, so second derivatives follow
the same rules, as ``jax.grad`` of ``jax.grad`` does in the JAX package.

``torch.compile`` traces no Function that defines ``jvp``. So each public
function that applies one is marked ``torch.compiler.allow_in_graph``: the
compiler records the call whole, and AOTAutograd then traces the Function's
forward and its backward rule into the forward and backward programs, as
``jax.jit`` traces a ``custom_jvp``.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable

import torch


def _safe(x: torch.Tensor, where_bad: torch.Tensor) -> torch.Tensor:
    """Replace entries where ``where_bad`` with 1 so they can be divided by."""
    return torch.where(where_bad, torch.ones_like(x), x)


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(x, value)


def presigned(function: type[torch.autograd.Function]) -> type[torch.autograd.Function]:
    """Class decorator: store the signature of ``function.forward``.
    ``Function.apply`` binds its arguments through ``inspect.signature`` on
    every call of a Function with ``setup_context``; ``inspect`` returns a
    stored ``__signature__`` as it stands, which saves that host time (~10
    us a call, as much as some kernels take)."""
    function.forward.__signature__ = inspect.signature(function.forward)
    return function


def _elementwise(
    name: str,
    value: Callable[..., torch.Tensor],
    partials: Callable[..., tuple[torch.Tensor, ...]],
) -> type[torch.autograd.Function]:
    """An autograd Function for the elementwise ``value(*xs)`` (its inputs
    broadcast against each other) whose partial derivatives with respect to
    each input are ``partials(*xs)``, both at the broadcast shape."""

    def broadcast(xs):
        return xs if len(xs) == 1 else torch.broadcast_tensors(*xs)

    def forward(*xs):
        return value(*broadcast(xs))

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    def backward(ctx, grad):
        xs = ctx.saved_tensors
        slopes = partials(*broadcast(xs))
        return tuple(
            (grad * slope).sum_to_size(x.shape) if needed else None
            for x, slope, needed in zip(xs, slopes, ctx.needs_input_grad)
        )

    def jvp(ctx, *tangents):
        slopes = partials(*broadcast(ctx.saved_tensors))
        terms = [slope * dx for slope, dx in zip(slopes, tangents) if dx is not None]
        total = terms[0]
        for term in terms[1:]:
            total = total + term
        return total

    return presigned(
        type(
            name,
            (torch.autograd.Function,),
            {
                "generate_vmap_rule": True,
                "forward": staticmethod(forward),
                "setup_context": staticmethod(setup_context),
                "backward": staticmethod(backward),
                "jvp": staticmethod(jvp),
            },
        )
    )


# ---------------------------------------------------------------------------
# cos_sqrt, sinc_sqrt and si1mdiv (the first-order transfer map's)
# ---------------------------------------------------------------------------


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
        x == 0, _const(x, 1.0 / 6.0), (1.0 - _sinc_sqrt_value(x)) / _safe(x, x == 0)
    )


def _dsinc_sqrt(x: torch.Tensor) -> torch.Tensor:
    """d/dx si(sqrt(x)) = (cos(sqrt(x)) - si(sqrt(x))) / (2x); limit -1/6."""
    return torch.where(
        x == 0,
        _const(x, -1.0 / 6.0),
        (cos_sqrt(x) - sinc_sqrt(x)) / (2.0 * _safe(x, x == 0)),
    )


def _dsi1mdiv(x: torch.Tensor) -> torch.Tensor:
    # f'(x) = (-si'(sqrt(x)) - f) / x with -si' = (si - cos)/(2x); limit -1/120.
    sx = (sinc_sqrt(x) - cos_sqrt(x)) / (2.0 * _safe(x, x == 0))
    return torch.where(x == 0, _const(x, -1.0 / 120.0), (sx - si1mdiv(x)) / _safe(x, x == 0))


# d/dx cos(sqrt(x)) = -si(sqrt(x)) / 2 (entire function, no singularity).
_CosSqrt = _elementwise("_CosSqrt", _cos_sqrt_value, lambda x: (-0.5 * sinc_sqrt(x),))
_SincSqrt = _elementwise("_SincSqrt", _sinc_sqrt_value, lambda x: (_dsinc_sqrt(x),))
_Si1mdiv = _elementwise("_Si1mdiv", _si1mdiv_value, lambda x: (_dsi1mdiv(x),))


@torch.compiler.allow_in_graph
def cos_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``cos(sqrt(x))`` extended evenly to negative ``x`` via ``cosh(sqrt(-x))``."""
    return _CosSqrt.apply(x)


@torch.compiler.allow_in_graph
def sinc_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sin(sqrt(x))/sqrt(x)``, evenly extended; 1 at ``x = 0``."""
    return _SincSqrt.apply(x)


@torch.compiler.allow_in_graph
def si1mdiv(x: torch.Tensor) -> torch.Tensor:
    """``(1 - sinc_sqrt(x)) / x`` with limit 1/6 at 0."""
    return _Si1mdiv.apply(x)


# ---------------------------------------------------------------------------
# Both planes' focusing functions from one set of transcendentals
# ---------------------------------------------------------------------------


def _cos_sinc_sqrt_pm_value(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    s = torch.sqrt(torch.abs(x))
    c = torch.cos(s)
    sn = torch.sin(s)
    em = torch.expm1(s)
    ratio = em / (1.0 + em)  # in [0, 1) for s >= 0
    ch = 1.0 + 0.5 * em * ratio
    sh = 0.5 * ratio * (2.0 + em)
    s_safe = _safe(s, s == 0)
    one = torch.ones_like(s)
    sinc_trig = torch.where(s == 0, one, sn / s_safe)
    sinc_hyp = torch.where(s == 0, one, sh / s_safe)
    pos = x >= 0
    return (
        torch.where(pos, c, ch),
        torch.where(pos, sinc_trig, sinc_hyp),
        torch.where(pos, ch, c),
        torch.where(pos, sinc_hyp, sinc_trig),
    )


def _cos_sinc_sqrt_pm_slopes(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    # d/dx cos_sqrt(x) = -si(sqrt(x))/2 for all x (entire even function);
    # d/dx si(sqrt(x)) = (cos_sqrt(x) - si(sqrt(x))) / (2x), limit -1/6.
    cp, sp, cm, sm = cos_sinc_sqrt_pm(x)
    two_x = _safe(2.0 * x, x == 0)
    return (
        -0.5 * sp,
        torch.where(x == 0, _const(x, -1.0 / 6.0), (cp - sp) / two_x),
        0.5 * sm,
        torch.where(x == 0, _const(x, 1.0 / 6.0), (cm - sm) / two_x),
    )


@presigned
class _CosSincSqrtPm(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _cos_sinc_sqrt_pm_value(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        (x,) = ctx.saved_tensors
        slopes = _cos_sinc_sqrt_pm_slopes(x)
        total = grads[0] * slopes[0]
        for grad, slope in zip(grads[1:], slopes[1:]):
            total = total + grad * slope
        return total

    @staticmethod
    def jvp(ctx, dx):
        (x,) = ctx.saved_tensors
        return tuple(slope * dx for slope in _cos_sinc_sqrt_pm_slopes(x))


@torch.compiler.allow_in_graph
def cos_sinc_sqrt_pm(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    r"""``(cos_sqrt(x), sinc_sqrt(x), cos_sqrt(-x), sinc_sqrt(-x))`` from one
    shared set of transcendentals (``sqrt``, ``cos``, ``sin``, ``expm1``).

    The quadrupole drift-kick-drift map needs the focusing functions of both
    transverse planes, whose arguments are ``+x`` and ``-x``: the trig and
    hyperbolic branches of the same ``s = sqrt(|x|)``. ``cosh``/``sinh``
    come from ``expm1`` without cancellation, ``cosh(s) - 1 = em^2 / (2 (1 +
    em))`` and ``sinh(s) = em (2 + em) / (2 (1 + em))`` with ``em =
    expm1(s)``, through the bounded ratio ``em / (1 + em)``, so that no
    intermediate squares ``em``.
    """
    return _CosSincSqrtPm.apply(x)


def cos_sinc_sqrt_series_pm(
    t: torch.Tensor, doublings: int = 4
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""``(cos_sqrt(t), sinc_sqrt(t), cos_sqrt(-t), sinc_sqrt(-t))`` by
    truncated Taylor series and double-angle reduction: products and sums
    only, no transcendental.

    ``F = cos_sqrt`` and ``G = sinc_sqrt`` are entire,
    ``F(t) = sum_k (-t)^k / (2k)!``, ``G(t) = sum_k (-t)^k / (2k+1)!``. The
    series (7 terms in float32, 11 in float64: truncation below the dtype's
    epsilon at reduced argument 1) is evaluated at ``t / 4^doublings`` and
    walked back up with ``G(4s) = G(s) F(s)`` and, on the versine
    ``P = F - 1``, ``P(4s) = 2 P (P + 2)``, which keeps the relative
    precision of a small total phase. Machine precision holds for
    ``|t| <= 4^doublings`` (256 at the default); beyond, the truncation
    error grows polynomially.
    """
    num_terms = 11 if t.dtype == torch.float64 else 7
    # hF(v) - 1 = v (E_P(v^2) + v O_P(v^2)), hG(v) = E_G(v^2) + v O_G(v^2),
    # with F(t) = hF(-t), G(t) = hG(-t); the -t outputs flip the odd parts.
    even_p = [1.0 / math.factorial(4 * j + 2) for j in range((num_terms + 1) // 2)]
    odd_p = [1.0 / math.factorial(4 * j + 4) for j in range(num_terms // 2)]
    even_g = [1.0 / math.factorial(4 * j + 1) for j in range((num_terms + 1) // 2)]
    odd_g = [1.0 / math.factorial(4 * j + 3) for j in range(num_terms // 2)]

    def horner(coeffs, v):
        acc = torch.full_like(v, coeffs[-1])
        for c in reversed(coeffs[:-1]):
            acc = acc * v + c
        return acc

    s = -t * (0.25**doublings)  # exact power-of-two scaling
    w = torch.square(s)
    ep, op = horner(even_p, w), s * horner(odd_p, w)
    eg, og = horner(even_g, w), s * horner(odd_g, w)
    pt, gt = s * (ep + op), eg + og  # F-1, G at the reduced +t
    pmt, gmt = -s * (ep - op), eg - og  # F-1, G at the reduced -t
    for _ in range(doublings):
        gt = gt * (1.0 + pt)
        pt = 2.0 * pt * (2.0 + pt)
        gmt = gmt * (1.0 + pmt)
        pmt = 2.0 * pmt * (2.0 + pmt)
    return 1.0 + pt, gt, 1.0 + pmt, gmt


# ---------------------------------------------------------------------------
# The second-order map's and the cavity's primitives
# ---------------------------------------------------------------------------


def _log1pdiv_value(x):
    return torch.where(x == 0, torch.ones_like(x), torch.log1p(x) / _safe(x, x == 0))


def _log1pdiv_slopes(x):
    return (
        torch.where(
            x == 0, _const(x, -0.5), (1.0 / (1.0 + x) - log1pdiv(x)) / _safe(x, x == 0)
        ),
    )


def _sicos1mdiv_value(x):
    return torch.where(
        x == 0,
        _const(x, 1.0 / 6.0),
        (1.0 - _sinc_sqrt_value(x) * _cos_sqrt_value(x)) / _safe(x, x == 0),
    )


def _sicos1mdiv_slopes(x):
    cx, sx = cos_sqrt(x), sinc_sqrt(x)
    x2 = _safe(x * x, x == 0)
    return (
        torch.where(
            x == 0,
            _const(x, -2.0 / 15.0),
            (sx * (x * sx + 2.0 * cx) - 2.0 - cx * cx + sx * cx) / (2.0 * x2),
        ),
    )


def _sipsicos3mdiv_value(x):
    sx = _sinc_sqrt_value(x)
    return torch.where(
        x == 0,
        torch.zeros_like(x),
        (3.0 - 4.0 * sx + sx * _cos_sqrt_value(x)) / (2.0 * _safe(x, x == 0)),
    )


def _sipsicos3mdiv_slopes(x):
    cx, sx = cos_sqrt(x), sinc_sqrt(x)
    x2 = _safe(x * x, x == 0)
    return (
        torch.where(
            x == 0,
            _const(x, 0.05),
            (-sx * (x * sx + 2.0 * cx - 8.0) - 6.0 + 4.0 * sx + cx * cx - (4.0 + sx) * cx)
            / (4.0 * x2),
        ),
    )


def _cossqrtmcosdivdiff_value(a, b):
    diff = _safe(a - b, a == b)
    return torch.where(
        a == b, 0.5 * _sinc_sqrt_value(a), (_cos_sqrt_value(b) - _cos_sqrt_value(a)) / diff
    )


def _cossqrtmcosdivdiff_slopes(a, b):
    sa, sb = sinc_sqrt(a), sinc_sqrt(b)
    ca, cb = cos_sqrt(a), cos_sqrt(b)
    ab = a - b
    cbca = cb - ca
    denom = _safe(ab * ab, a == b)
    limit = torch.where(a == 0, _const(a, -1.0 / 24.0), (ca - sa) / (8.0 * _safe(a, a == 0)))
    return (
        torch.where(a == b, limit, (0.5 * sa * ab - cbca) / denom),
        torch.where(a == b, limit, -(0.5 * sb * ab - cbca) / denom),
    )


def _simsidivdiff_value(a, b):
    diff = _safe(b - a, a == b)
    aeqb_limit = torch.where(
        b == 0,
        _const(b, 1.0 / 6.0),
        0.5 * (_sinc_sqrt_value(b) - _cos_sqrt_value(b)) / _safe(b, b == 0),
    )
    return torch.where(
        a == b, aeqb_limit, (_sinc_sqrt_value(a) - _sinc_sqrt_value(b)) / diff
    )


def _simsidivdiff_slopes(a, b):
    sa, sb = sinc_sqrt(a), sinc_sqrt(b)
    ca, cb = cos_sqrt(a), cos_sqrt(b)
    ba = _safe(b - a, a == b)
    a_safe = _safe(a, a == 0)
    b_safe = _safe(b, b == 0)
    aeqb_limit = torch.where(
        b == 0, _const(a, -1.0 / 120.0), (3.0 * cb + (b - 3.0) * sb) / (8.0 * b_safe * b_safe)
    )
    aneqb_a0_limit = (1.0 - b / 6.0 - sb) / (b_safe * b_safe)
    aneqb_b0_limit = (1.0 - a / 6.0 - sa) / (a_safe * a_safe)
    grad_a = torch.where(
        (a != b) & (a != 0),
        (ca - sa) / (2.0 * a_safe * ba) + (sa - sb) / (ba * ba),
        torch.where(a != b, aneqb_a0_limit, aeqb_limit),
    )
    grad_b = torch.where(
        (a != b) & (b != 0),
        -(cb - sb) / (2.0 * b_safe * ba) + (sb - sa) / (ba * ba),
        torch.where(a != b, aneqb_b0_limit, aeqb_limit),
    )
    return grad_a, grad_b


def _si2msi2divdiff_value(a, b):
    diff = _safe(a - b, a == b)
    sb, cb = _sinc_sqrt_value(b), _cos_sqrt_value(b)
    aeqb_limit = torch.where(
        b == 0,
        _const(b, 1.0 / 3.0),
        (1.0 - cb * cb - b * sb * cb) / _safe(b * b, b == 0),
    )
    sa = _sinc_sqrt_value(a)
    return torch.where(a == b, aeqb_limit, (sb * sb - sa * sa) / diff)


def _si2msi2divdiff_slopes(a, b):
    sa, sb = sinc_sqrt(a), sinc_sqrt(b)
    ca, cb = cos_sqrt(a), cos_sqrt(b)
    ab = _safe(a - b, a == b)
    a_safe = _safe(a, a == 0)
    b_safe = _safe(b, b == 0)
    a0_limit = (b - b * b / 3.0 + cb * cb - 1.0) / (b_safe**3)
    b0_limit = (a - a * a / 3.0 + ca * ca - 1.0) / (a_safe**3)
    aeqb_limit = torch.where(
        b == 0,
        _const(a, -2.0 / 45.0),
        (5.0 * b * sb * cb - (b - 2.0) * (2.0 * cb * cb - 1.0) - 2.0) / (4.0 * b_safe**3),
    )
    grad_a = torch.where(
        (a != b) & (a != 0),
        (-ab * sa * (ca - sa) / a_safe + sa * sa - sb * sb) / (ab * ab),
        torch.where(a == b, aeqb_limit, a0_limit),
    )
    grad_b = torch.where(
        (a != b) & (b != 0),
        (ab * sb * (cb - sb) / b_safe + sb * sb - sa * sa) / (ab * ab),
        torch.where(a == b, aeqb_limit, b0_limit),
    )
    return grad_a, grad_b


def _sqrta2minusbdiva_value(a, b):
    return torch.where(
        b == 0, 1.0 / (2.0 * a), (torch.sqrt(a * a + b) - a) / _safe(b, b == 0)
    )


def _sqrta2minusbdiva_slopes(a, b):
    b_safe = _safe(b, b == 0)
    root = torch.sqrt(a * a + b)
    return (
        torch.where(b == 0, -1.0 / (2.0 * a * a), (a / root - 1.0) / b_safe),
        torch.where(
            b == 0,
            -1.0 / (8.0 * a**3),
            ((-2.0 * a * a - b) / root + 2.0 * a) / (2.0 * b_safe * b_safe),
        ),
    )


_Log1pdiv = _elementwise("_Log1pdiv", _log1pdiv_value, _log1pdiv_slopes)
_Sicos1mdiv = _elementwise("_Sicos1mdiv", _sicos1mdiv_value, _sicos1mdiv_slopes)
_Sipsicos3mdiv = _elementwise("_Sipsicos3mdiv", _sipsicos3mdiv_value, _sipsicos3mdiv_slopes)
_Cossqrtmcosdivdiff = _elementwise(
    "_Cossqrtmcosdivdiff", _cossqrtmcosdivdiff_value, _cossqrtmcosdivdiff_slopes
)
_Simsidivdiff = _elementwise("_Simsidivdiff", _simsidivdiff_value, _simsidivdiff_slopes)
_Si2msi2divdiff = _elementwise("_Si2msi2divdiff", _si2msi2divdiff_value, _si2msi2divdiff_slopes)
_Sqrta2minusbdiva = _elementwise(
    "_Sqrta2minusbdiva", _sqrta2minusbdiva_value, _sqrta2minusbdiva_slopes
)


@torch.compiler.allow_in_graph
def log1pdiv(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x) / x`` with limit 1 at 0."""
    return _Log1pdiv.apply(x)


@torch.compiler.allow_in_graph
def sicos1mdiv(x: torch.Tensor) -> torch.Tensor:
    """``(1 - si(sqrt(x)) cos(sqrt(x))) / x`` with limit 1/6 at 0."""
    return _Sicos1mdiv.apply(x)


@torch.compiler.allow_in_graph
def sipsicos3mdiv(x: torch.Tensor) -> torch.Tensor:
    """``(3 - 4 si(sqrt(x)) + si(sqrt(x)) cos(sqrt(x))) / (2x)``, limit 0."""
    return _Sipsicos3mdiv.apply(x)


@torch.compiler.allow_in_graph
def cossqrtmcosdivdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(cos(sqrt(b)) - cos(sqrt(a))) / (a - b)``, limit ``si(sqrt(a))/2``
    at ``a == b``."""
    return _Cossqrtmcosdivdiff.apply(a, b)


@torch.compiler.allow_in_graph
def simsidivdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(si(sqrt(a)) - si(sqrt(b))) / (b - a)`` with nested limits at
    ``a == b`` and ``b == 0``."""
    return _Simsidivdiff.apply(a, b)


@torch.compiler.allow_in_graph
def si2msi2divdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(si^2(sqrt(b)) - si^2(sqrt(a))) / (a - b)`` with nested limits."""
    return _Si2msi2divdiff.apply(a, b)


@torch.compiler.allow_in_graph
def sqrta2minusbdiva(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(sqrt(a^2 + b) - a) / b`` with limit ``1 / (2a)`` at ``b == 0``."""
    return _Sqrta2minusbdiva.apply(a, b)
