"""The plain reference's quadrupole map and its derivative in ``k1`` are
finite and continuous at and near ``k1 = 0``, where the closed form's
square root has no derivative."""

import math

import pytest
import torch

from portbench.reference import optics

LENGTH = 0.122


def _entries(k1: float):
    k = torch.tensor([k1], dtype=torch.float64, requires_grad=True)
    cosine, sine = optics._focusing(k, torch.tensor(LENGTH, dtype=torch.float64))
    (dcos,) = torch.autograd.grad(cosine.sum(), k, retain_graph=True)
    (dsin,) = torch.autograd.grad(sine.sum(), k)
    return cosine.item(), sine.item(), dcos.item(), dsin.item()


@pytest.mark.parametrize("k1", [0.0, 1e-12, -1e-12, 1e-6, -1e-6, 0.5, -0.5, 20.0, -20.0])
def test_focusing_matches_the_closed_form_with_finite_derivatives(k1):
    cosine, sine, dcos, dsin = _entries(k1)
    root = math.sqrt(abs(k1))
    phase = root * LENGTH
    if k1 > 0:
        expected = (math.cos(phase), math.sin(phase) / root)
    elif k1 < 0:
        expected = (math.cosh(phase), math.sinh(phase) / root)
    else:
        expected = (1.0, LENGTH)
    assert (cosine, sine) == pytest.approx(expected, rel=1e-14)
    assert math.isfinite(dcos) and math.isfinite(dsin)
    # Central differences where the closed form is well conditioned.
    if abs(k1) >= 0.5:
        step = 1e-6
        fd = [(a - b) / (2 * step) for a, b in zip(_entries(k1 + step), _entries(k1 - step))]
        assert (dcos, dsin) == pytest.approx(fd[:2], rel=1e-7)


def test_focusing_derivative_is_continuous_at_zero():
    # d cos(sqrt(k) L) / dk = -L^2 / 2 and d (sin(sqrt(k) L) / sqrt(k)) / dk = -L^3 / 6 at 0.
    _, _, dcos, dsin = _entries(0.0)
    assert dcos == pytest.approx(-LENGTH**2 / 2, rel=1e-14)
    assert dsin == pytest.approx(-LENGTH**3 / 6, rel=1e-14)
    for k1 in (1e-9, -1e-9):
        _, _, near_dcos, near_dsin = _entries(k1)
        assert near_dcos == pytest.approx(dcos, rel=1e-8)
        assert near_dsin == pytest.approx(dsin, rel=1e-8)
    # The series and the closed form meet at the switch.
    edge = optics.SERIES_BELOW / LENGTH**2
    below, above = _entries(edge * (1 - 1e-12)), _entries(edge * (1 + 1e-12))
    assert below == pytest.approx(above, rel=1e-9)
