"""First-order optics of the elements the benchmark's lattices hold, the
particle transport and the moment readout, in plain PyTorch.

The maps are Cheetah's (``base_rmatrix`` with no bending, its drift and its
thin-kick correctors) on the 7-vector ``(x, px, y, py, tau, p, 1)``:

- a drift of length ``L``: ``x += L px``, ``y += L py``,
  ``tau += -L / (beta^2 gamma^2) p``;
- a quadrupole of length ``L`` and strength ``k1``: the focusing and
  defocusing 2x2 blocks ``cos(sqrt(k) L)``, ``sin(sqrt(k) L) / sqrt(k)``
  (cosh and sinh where ``k < 0``) with ``k = k1`` in x and ``-k1`` in y,
  and the drift's ``tau``-``p`` term;
- a horizontal (vertical) corrector: a drift whose ``px`` (``py``) gains
  ``angle`` through the constant 7th coordinate;
- a marker: the identity.

Another element type's map is a file of its own, ``maps/<type>.py`` beside
this one, found by the type's name: its ``transfer_map(element, values,
energy, batch, dtype, device)`` gives the ``(batch, 7, 7)`` map.
"""

from __future__ import annotations

import contextlib
import contextvars
import importlib.util
import math
import pathlib

import torch
from scipy.constants import physical_constants

#: Electron rest energy in eV and mass in kg (CODATA, as scipy gives them).
ELECTRON_MASS_EV = physical_constants["electron mass energy equivalent in MeV"][0] * 1e6
ELECTRON_MASS_KG = physical_constants["electron mass"][0]


_TF32 = contextvars.ContextVar("tf32_products", default=False)


@contextlib.contextmanager
def tf32_products():
    """Matrix products in TF32 inside the block: each float32 operand
    rounded to TF32's 10-bit mantissa (to nearest, ties to even), as the
    card's tensor cores take it, the products accumulated in float32.
    Rounding the operands here makes the precision independent of which
    kernel cuBLAS picks, which for the particles' 7-wide products ignores
    ``allow_tf32`` and stays in full float32."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def to_tf32(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` (float32) rounded to TF32."""
    bits = tensor.detach().contiguous().view(torch.int32)
    rounded = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and its backward's
    products too (the gradient and the saved operands rounded)."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = to_tf32(grad)
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = torch.matmul(grad, b.transpose(-1, -2)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            grad_b = torch.matmul(a.transpose(-1, -2), grad).sum_to_size(b.shape)
        return grad_a, grad_b


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, in TF32 inside :func:`tf32_products`."""
    if _TF32.get() and a.dtype == torch.float32:
        return _TF32Product.apply(a, b)
    return torch.matmul(a, b)


def relativistic(energy: float) -> tuple[float, float, float]:
    """``(gamma, 1 / gamma^2, beta)`` of an electron of ``energy`` eV."""
    gamma = energy / ELECTRON_MASS_EV
    igamma2 = 1.0 / gamma**2
    return gamma, igamma2, (1.0 - igamma2) ** 0.5


def _identity(batch: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.eye(7, dtype=dtype, device=device).repeat(batch, 1, 1)


#: Below this ``|k| L^2`` a quadrupole's map is summed as its Taylor series
#: in ``k L^2``, whose derivative in ``k`` is finite and free of
#: cancellation at and near ``k = 0``; the closed form above it.
SERIES_BELOW = 1e-2
SERIES_TERMS = 8


def _focusing(k: torch.Tensor, length: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos(sqrt(k) L), sin(sqrt(k) L) / sqrt(k))``, continued to ``k <= 0``
    (``cosh``, ``sinh``)."""
    x = k * length**2
    small = x.abs() < SERIES_BELOW
    safe = torch.where(small, torch.ones_like(x), x)
    root = torch.sqrt(safe.abs())
    cos_closed = torch.where(safe > 0, torch.cos(root), torch.cosh(root))
    sinc_closed = torch.where(safe > 0, torch.sin(root), torch.sinh(root)) / root
    # cos(sqrt(x)) = sum (-x)^n / (2n)!, sin(sqrt(x)) / sqrt(x) = sum (-x)^n / (2n + 1)!
    power, cos_series, sinc_series = torch.ones_like(x), 0.0, 0.0
    for n in range(SERIES_TERMS):
        cos_series = cos_series + power / math.factorial(2 * n)
        sinc_series = sinc_series + power / math.factorial(2 * n + 1)
        power = power * -x
    return (torch.where(small, cos_series, cos_closed),
            length * torch.where(small, sinc_series, sinc_closed))


MAPS_DIR = pathlib.Path(__file__).resolve().parent / "maps"


def _map_module(kind: str):
    """``maps/<kind>.py``, the first-order map of an element type added as a
    file."""
    path = MAPS_DIR / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"The reference has no first-order map of a {kind} ({path}).")
    spec = importlib.util.spec_from_file_location(f"portbench_reference_map_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def element_map(element: dict, values: dict, energy: float, batch: int, dtype, device):
    """The ``(batch, 7, 7)`` first-order map of one element.

    :param element: The element as the configuration states it (``type``
        and its parameters).
    :param values: Parameter name -> tensor of shape ``(batch,)`` or ``()``,
        the element's parameters with the step's settings applied.
    """
    kind = element["type"]
    if kind not in ("Marker", "Drift", "Quadrupole", "HorizontalCorrector",
                    "VerticalCorrector"):
        return _map_module(kind).transfer_map(element, values, energy, batch, dtype, device)
    R = _identity(batch, dtype, device)
    if kind == "Marker":
        return R
    _, igamma2, beta = relativistic(energy)
    length = values["length"].expand(batch)
    R[:, 4, 5] = -length / beta**2 * igamma2
    if kind == "Quadrupole":
        k1 = values.get("k1", torch.zeros((), dtype=dtype, device=device)).expand(batch)
        cx, sx = _focusing(k1, length)
        cy, sy = _focusing(-k1, length)
        R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = cx, sx, -k1 * sx, cx
        R[:, 2, 2], R[:, 2, 3], R[:, 3, 2], R[:, 3, 3] = cy, sy, k1 * sy, cy
        return R
    R[:, 0, 1] = length
    R[:, 2, 3] = length
    if kind == "HorizontalCorrector":
        R[:, 1, 6] = values.get("angle", torch.zeros((), dtype=dtype, device=device)).expand(batch)
    elif kind == "VerticalCorrector":
        R[:, 3, 6] = values.get("angle", torch.zeros((), dtype=dtype, device=device)).expand(batch)
    return R


def transport(particles: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Particles ``(..., N, 7)`` through the maps ``(..., 7, 7)``."""
    return product(particles, R.transpose(-1, -2))


def sigma(values: torch.Tensor) -> torch.Tensor:
    """Unbiased standard deviation over the last dimension, in two passes."""
    centred = values - values.mean(dim=-1, keepdim=True)
    return torch.sqrt(torch.sum(centred * centred, dim=-1) / (values.shape[-1] - 1))
