"""Gradients of the PyTorch port against ``jax.grad`` of cheetah_tpu.

- The singularity-free maths functions: first and second derivatives at 0,
  where autograd through ``sqrt(clamp(x))`` gave NaN, and around it.
- The autograd closure of the CIC kernels (``GatherMulti``, ``DepositMulti``)
  against ``jax.grad`` through the JAX package's primitives and its
  ``differentiable_pallas_gather/_deposit`` in interpret mode, at all 8
  orders, on an untiled and a tiled grid; and ``gradcheck`` /
  ``gradgradcheck`` in float64.
- The space-charge segment's gradient with respect to the first drift
  length (``space_charge_grad`` of ``scripts/bench_all.py``) and the env
  step's ``k1`` gradient, both in float64.

The Pallas kernels work in float32. Their gradients agree with the port's
float32 plain versions to the rounding of float32 sums, K * eps * M for K
terms of size M, which each test states.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from cheetah_tpu.ops.pallas_cic import (
    cic_deposit_multi_p,
    cic_gather_multi_p,
    differentiable_pallas_deposit,
    differentiable_pallas_gather,
)
from cheetah_tpu.utils import maths as jax_maths
from cheetah_tpu_torch.ops import cic_kernels, cic_tiled
from cheetah_tpu_torch.ops.cloud_in_cell import cloud_in_cell_charge_deposition
from cheetah_tpu_torch.utils import maths, profiling
from test_torch_tracking import beam_to_torch, segment_to_torch

ALL_ORDERS = tuple(itertools.product((0, 1), repeat=3))
F32_EPS = float(np.finfo(np.float32).eps)
UNTILED, TILED = (8, 7, 6), (160, 40, 16)

# ---------------------------------------------------------------------------
# maths
# ---------------------------------------------------------------------------

# Both packages evaluate the same closed forms, which cancel near 0: the
# first derivatives of si1mdiv divide a difference of ~1/6 by x and lose
# eps / |x| (2e-12 absolute at |x| = 1e-2), the second derivatives divide
# once more. The points stay at |x| >= 1e-2, where the first derivatives
# agree to 1e-9 and the second to 1e-6 relative.
POINTS = np.array([0.0, 1e-2, -1e-2, 0.3, -0.3, 2.5, -4.0, 30.0, -30.0])
LIMITS = {"cos_sqrt": -0.5, "sinc_sqrt": -1.0 / 6.0, "si1mdiv": -1.0 / 120.0}


def _torch_derivatives(function, points):
    x = torch.tensor(points, dtype=torch.float64, requires_grad=True)
    (first,) = torch.autograd.grad(function(x).sum(), x, create_graph=True)
    (second,) = torch.autograd.grad(first.sum(), x)
    return first.detach().numpy(), second.numpy()


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_maths_derivatives_match_jax(name):
    jax_function = getattr(jax_maths, name)
    points = jnp.asarray(POINTS)
    expected_first = np.asarray(jax.vmap(jax.grad(jax_function))(points))
    expected_second = np.asarray(jax.vmap(jax.grad(jax.grad(jax_function)))(points))
    first, second = _torch_derivatives(getattr(maths, name), POINTS)
    np.testing.assert_allclose(first, expected_first, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(second, expected_second, rtol=1e-6, atol=1e-12)
    # The forward values did not change.
    np.testing.assert_allclose(
        getattr(maths, name)(torch.from_numpy(POINTS)).numpy(),
        np.asarray(jax_function(points)),
        rtol=1e-14,
    )


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_maths_derivatives_at_zero_are_the_analytic_limits(name):
    first, second = _torch_derivatives(getattr(maths, name), np.zeros(3))
    assert np.all(np.isfinite(first)) and np.all(np.isfinite(second))
    assert first[0] == pytest.approx(LIMITS[name], rel=1e-15)


def test_quadrupole_gradient_at_zero_strength_is_finite():
    """d sigma_x / d k1 at k1 = 0 and at length 0, through the first-order
    map, against jax.grad."""
    beam = _jax_twiss_beam(400, 8)
    port_beam = beam_to_torch(beam)
    for name, value in (("k1", 0.0), ("length", 0.0)):
        port_segment = segment_to_torch(jax_ares_ea_subcell(dtype=jnp.float64))

        def jax_loss(v, s, name=name):
            setattr(s.AREAMQZM2, name, v)
            return s.track(beam).sigma_x

        expected = float(
            jax.grad(jax_loss)(jnp.asarray(value), jax_ares_ea_subcell(dtype=jnp.float64))
        )
        v = torch.tensor(value, dtype=torch.float64, requires_grad=True)
        setattr(port_segment.AREAMQZM2, name, v)
        (actual,) = torch.autograd.grad(port_segment.track(port_beam).sigma_x, v)
        assert np.isfinite(actual.item()), name
        assert actual.item() == pytest.approx(expected, rel=1e-10), name


# ---------------------------------------------------------------------------
# The autograd closure of the CIC kernels
# ---------------------------------------------------------------------------


def _case(seed, shape, batch=2, components=2, num_particles=600):
    """float32 grids, weights and rows, and positions spilling past every
    edge (finite: the gradients are compared where both packages define
    them)."""
    rng = np.random.default_rng(seed)
    normalized = rng.uniform(
        -1.5, np.asarray(shape) + 0.5, size=(batch, num_particles, 3)
    ).astype(np.float32)
    normalized[:, ::10] = -2.0
    grids = rng.normal(size=(batch, components, *shape)).astype(np.float32)
    weights = rng.normal(size=(len(ALL_ORDERS), batch, components, num_particles)).astype(
        np.float32
    )
    rows = rng.normal(size=(batch, len(ALL_ORDERS), components, num_particles)).astype(
        np.float32
    )
    return normalized, grids, weights, rows


def _grad_tolerance(expected, terms):
    """K * eps * max|expected|: K float32 terms summed per output."""
    return terms * F32_EPS * float(np.abs(expected).max())


@pytest.mark.parametrize("shape", [UNTILED, TILED], ids=["untiled", "tiled"])
def test_gather_multi_gradients_match_jax_all_orders(shape):
    normalized, grids, weights, _ = _case(40, shape)
    assert cic_kernels.uses_tiled(shape) == (shape == TILED)

    def jax_loss(g, n):
        outs = cic_gather_multi_p.bind(g, n, orders=ALL_ORDERS, interpret=True)
        return sum(jnp.sum(w * o) for w, o in zip(weights, outs))

    expected_grids, expected_positions = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(grids), jnp.asarray(normalized)
    )
    g = torch.from_numpy(grids).requires_grad_()
    n = torch.from_numpy(normalized).requires_grad_()
    outs = cic_kernels.differentiable_gather(g, n, ALL_ORDERS)
    loss = sum(torch.sum(torch.from_numpy(w) * o) for w, o in zip(weights, outs))
    actual_grids, actual_positions = torch.autograd.grad(loss, (g, n))
    # The grids' gradient is a deposit: each cell sums 8 orders x a few
    # particles; a position's gradient sums 8 orders x 2 components x 8
    # corners of raised weights.
    np.testing.assert_allclose(
        actual_grids.numpy(), np.asarray(expected_grids), rtol=0,
        atol=_grad_tolerance(expected_grids, 64),
    )
    np.testing.assert_allclose(
        actual_positions.numpy(), np.asarray(expected_positions), rtol=0,
        atol=_grad_tolerance(expected_positions, 128),
    )
    # Parked particles get no gradient.
    assert torch.all(actual_positions[:, ::10] == 0)


@pytest.mark.parametrize("shape", [UNTILED, TILED], ids=["untiled", "tiled"])
def test_deposit_multi_gradients_match_jax_all_orders(shape):
    normalized, grids, _, rows = _case(41, shape)

    def jax_loss(n, r):
        grid = cic_deposit_multi_p.bind(
            n, r, histogram_shape=shape, orders=ALL_ORDERS, interpret=True
        )
        return jnp.sum(grid * jnp.asarray(grids))

    expected_positions, expected_rows = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(normalized), jnp.asarray(rows)
    )
    n = torch.from_numpy(normalized).requires_grad_()
    r = torch.from_numpy(rows).requires_grad_()
    grid = cic_kernels.differentiable_deposit(n, r, shape, ALL_ORDERS)
    actual_positions, actual_rows = torch.autograd.grad(
        torch.sum(grid * torch.from_numpy(grids)), (n, r)
    )
    np.testing.assert_allclose(
        actual_rows.numpy(), np.asarray(expected_rows), rtol=0,
        atol=_grad_tolerance(expected_rows, 16),
    )
    np.testing.assert_allclose(
        actual_positions.numpy(), np.asarray(expected_positions), rtol=0,
        atol=_grad_tolerance(expected_positions, 128),
    )


@pytest.mark.parametrize("shape", [UNTILED, TILED], ids=["untiled", "tiled"])
def test_public_differentiable_gather_and_deposit_match_jax(shape):
    """The kick's two entries, at the value order: the gather through
    ``differentiable_pallas_gather`` and the raw-coordinate deposit (bin
    space, extent mask, parking) through ``differentiable_pallas_deposit``,
    with gradients with respect to grids, positions, charges and extent."""
    rng = np.random.default_rng(42)
    normalized, grids, weights, _ = _case(43, shape)
    jax_gather = differentiable_pallas_gather(True)

    def jax_gather_loss(g, n):
        return jnp.sum(jnp.asarray(weights[0]) * jax_gather(g, n))

    expected = jax.grad(jax_gather_loss, argnums=(0, 1))(
        jnp.asarray(grids), jnp.asarray(normalized)
    )
    g = torch.from_numpy(grids).requires_grad_()
    n = torch.from_numpy(normalized).requires_grad_()
    (values,) = cic_kernels.differentiable_gather(g, n)
    actual = torch.autograd.grad(torch.sum(torch.from_numpy(weights[0]) * values), (g, n))
    for got, want, terms in zip(actual, expected, (16, 32)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=0, atol=_grad_tolerance(want, terms)
        )

    positions = rng.normal(size=(2, 600, 3)).astype(np.float32)
    charges = rng.uniform(0.5, 1.0, size=(2, 600)).astype(np.float32)
    extent = np.broadcast_to(
        np.array([[-2.5, 2.5], [-2.0, 2.2], [-3.0, 3.0]], np.float32), (2, 3, 2)
    ).copy()
    target = rng.normal(size=(2, *shape)).astype(np.float32)
    jax_deposit = differentiable_pallas_deposit(shape, True)

    def jax_deposit_loss(p, q, e):
        return jnp.sum(jnp.asarray(target) * jax_deposit(p, q, e))

    expected = jax.grad(jax_deposit_loss, argnums=(0, 1, 2))(
        jnp.asarray(positions), jnp.asarray(charges), jnp.asarray(extent)
    )
    p = torch.from_numpy(positions).requires_grad_()
    q = torch.from_numpy(charges).requires_grad_()
    e = torch.from_numpy(extent).requires_grad_()
    grid = cloud_in_cell_charge_deposition(p, shape, e, q)
    actual = torch.autograd.grad(torch.sum(torch.from_numpy(target) * grid), (p, q, e))
    # The extent's gradient sums every particle's position gradient.
    for got, want, terms in zip(actual, expected, (64, 16, 600 * 64)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=0, atol=_grad_tolerance(want, terms)
        )


@pytest.mark.parametrize("shape", [(4, 5, 3), (1025, 4, 2)], ids=["untiled", "tiled"])
def test_autograd_closure_gradcheck_f64(shape):
    """gradcheck and gradgradcheck of both Functions in float64, where the
    backward of the backward stays on the same Functions. Positions are
    kept off the integers, where the weights have kinks."""
    assert cic_kernels.uses_tiled(shape) == (shape == (1025, 4, 2))
    rng = np.random.default_rng(44)
    num_particles = 12
    positions = rng.uniform(-0.8, np.asarray(shape) - 0.2, size=(1, num_particles, 3))
    positions += np.where(np.abs(positions - np.round(positions)) < 0.05, 0.1, 0.0)
    normalized = torch.tensor(positions, requires_grad=True)
    grids = torch.tensor(rng.normal(size=(1, 2, *shape)), requires_grad=True)
    rows = torch.tensor(rng.normal(size=(1, 3, 2, num_particles)), requires_grad=True)
    orders = ((0, 0, 0), (1, 0, 0), (0, 1, 1))

    def gather(g, n):
        return cic_kernels.differentiable_gather(g, n, orders)

    def deposit(n, r):
        return cic_kernels.differentiable_deposit(n, r, shape, orders)

    options = {"fast_mode": True, "atol": 1e-7, "rtol": 1e-6}
    assert torch.autograd.gradcheck(gather, (grids, normalized), **options)
    assert torch.autograd.gradgradcheck(gather, (grids, normalized), **options)
    assert torch.autograd.gradcheck(deposit, (normalized, rows), **options)
    assert torch.autograd.gradgradcheck(deposit, (normalized, rows), **options)


def test_backward_launches_nothing_for_inputs_without_gradient(monkeypatch):
    """``needs_input_grad``: a gather whose grids need no gradient deposits
    nothing in backward."""
    shape = (6, 6, 6)
    normalized, grids, _, _ = _case(45, shape, batch=1, components=1, num_particles=50)
    n = torch.from_numpy(normalized).double().requires_grad_()
    g = torch.from_numpy(grids).double()
    calls = []
    original = cic_kernels.DepositMulti.apply
    monkeypatch.setattr(
        cic_kernels.DepositMulti, "apply", lambda *args: calls.append(args) or original(*args)
    )
    (values,) = cic_kernels.differentiable_gather(g, n)
    values.sum().backward()
    assert calls == [] and n.grad is not None
    g.requires_grad_()
    (values,) = cic_kernels.differentiable_gather(g, n)
    values.sum().backward()
    assert len(calls) == 1 and g.grad is not None


# ---------------------------------------------------------------------------
# Paths: the space-charge segment and the env step
# ---------------------------------------------------------------------------


def _jax_twiss_beam(num_particles, seed, **extra):
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    return ct.ParticleBeam.from_twiss(
        num_particles=num_particles,
        beta_x=a(5.0),
        alpha_x=a(-1.0),
        emittance_x=a(2e-9),
        beta_y=a(3.0),
        alpha_y=a(0.5),
        emittance_y=a(2e-9),
        energy=a(1.54e8),
        total_charge=a(1e-10),
        key=jax.random.PRNGKey(seed),
        dtype=jnp.float64,
        **{k: a(v) for k, v in extra.items()},
    )


@pytest.mark.parametrize("grid", [(32, 32, 32), TILED], ids=["32^3", "tiled"])
def test_space_charge_segment_gradient_matches_jax(grid):
    """value_and_grad of sum(px^2) with respect to the first drift's length
    through Drift-Kick-Drift-Kick-Drift (``space_charge_grad`` of
    ``scripts/bench_all.py:426-433``), 20k particles, float64. The (160,
    40, 16) grid goes to the tiled plain versions, forward and backward."""
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    jax_segment = ct.Segment(
        [
            ct.Drift(a(0.1)),
            ct.SpaceChargeKick(a(0.2), grid_shape=grid),
            ct.Drift(a(0.1)),
            ct.SpaceChargeKick(a(0.2), grid_shape=grid),
            ct.Drift(a(0.1)),
        ]
    )
    jax_beam = _jax_twiss_beam(20_000, 5, sigma_tau=1e-5, sigma_p=1e-4)
    segment = segment_to_torch(jax_segment)
    beam = beam_to_torch(jax_beam)

    def jax_loss(length, s, b):
        s.elements[0].length = length
        return jnp.sum(jnp.square(s.track(b).px))

    expected_value, expected_grad = jax.value_and_grad(jax_loss)(a(0.1), jax_segment, jax_beam)

    length = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    segment.elements[0].length = length
    names = ("deposit_multi_tiled_3d", "deposit_multi_3d")
    launches = [profiling.counters().get(name, 0) for name in names]
    value = torch.sum(torch.square(segment.track(beam).px))
    (grad,) = torch.autograd.grad(value, length)
    assert launches == [profiling.counters().get(name, 0) for name in names]
    assert value.item() == pytest.approx(float(expected_value), rel=1e-12)
    # float64 on both sides: the packages differ in summation order only
    # (rel 1e-13 measured).
    assert grad.item() == pytest.approx(float(expected_grad), rel=1e-10)
    assert float(expected_grad) != 0


def test_env_step_k1_gradient_matches_jax():
    """d sum(sigma_x) / d k1 over 5 instances of the env step, one at
    exactly k1 = 0, float64."""
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64)
    jax_beam = _jax_twiss_beam(1000, 9)
    k1 = np.linspace(-20, 20, 5)
    assert k1[2] == 0

    def jax_loss(k1, s, b):
        s.AREAMQZM1.k1 = k1
        return jnp.sum(s.track(b).sigma_x)

    segment = segment_to_torch(jax_segment)
    beam = beam_to_torch(jax_beam)
    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(k1), jax_segment, jax_beam))
    k1_torch = torch.tensor(k1, requires_grad=True)
    segment.AREAMQZM1.k1 = k1_torch
    (actual,) = torch.autograd.grad(segment.track(beam).sigma_x.sum(), k1_torch)
    assert np.all(np.isfinite(actual.numpy()))
    np.testing.assert_allclose(actual.numpy(), expected, rtol=1e-10)
