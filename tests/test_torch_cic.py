"""The plain PyTorch versions of the CIC kernels against the JAX Pallas
kernels run in interpret mode (``deposit_multi_3d_pallas`` and
``gather_multi_3d_pallas``), at all 8 derivative orders, and the 3D charge
deposition against cheetah_tpu's.

The Pallas kernels contract two-hot tiles with matrix products; the plain
versions add corner by corner. Both work in float32, so they agree to the
rounding of an f32 sum: with at most K terms of size M per output, to about
K * eps * M, which each test states as its absolute tolerance.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_tpu.ops.cloud_in_cell import (
    cloud_in_cell_charge_deposition as jax_deposition,
)
from cheetah_tpu.ops.pallas_cic import deposit_multi_3d_pallas, gather_multi_3d_pallas
from cheetah_tpu_torch.ops import cic_kernels
from cheetah_tpu_torch.ops.cloud_in_cell import cloud_in_cell_charge_deposition

ALL_ORDERS = tuple(itertools.product((0, 1), repeat=3))
F32_EPS = float(np.finfo(np.float32).eps)


def _positions(rng, batch, num_particles, shape):
    """Bin-space positions that spill past every edge, with a tenth of the
    particles parked at -2 as the JAX package parks masked particles."""
    normalized = rng.uniform(
        -1.5, np.asarray(shape) + 0.5, size=(batch, num_particles, 3)
    ).astype(np.float32)
    normalized[:, ::10] = -2.0
    return normalized


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 5, 4)], ids=["8^3", "6x5x4"])
def test_deposit_reference_matches_pallas_all_orders(shape):
    rng = np.random.default_rng(10)
    batch, components, num_particles = 2, 2, 1500
    normalized = _positions(rng, batch, num_particles, shape)
    rows = rng.normal(size=(batch, len(ALL_ORDERS), components, num_particles)).astype(
        np.float32
    )
    expected = np.asarray(
        deposit_multi_3d_pallas(
            jnp.asarray(normalized), jnp.asarray(rows), shape, ALL_ORDERS, interpret=True
        )
    )
    actual = cic_kernels.deposit_multi_3d_reference(
        torch.from_numpy(normalized), torch.from_numpy(rows), shape, ALL_ORDERS
    )
    assert actual.shape == (batch, components, *shape) == expected.shape
    # Each cell sums 8 orders x ~N*8/cells corner terms of |row| <~ 4.
    terms = len(ALL_ORDERS) * num_particles * 8 / np.prod(shape)
    atol = terms * F32_EPS * 4
    np.testing.assert_allclose(actual.numpy(), expected, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 5, 4)], ids=["8^3", "6x5x4"])
def test_gather_reference_matches_pallas_all_orders(shape):
    rng = np.random.default_rng(11)
    batch, components, num_particles = 2, 2, 1500
    normalized = _positions(rng, batch, num_particles, shape)
    grids = rng.normal(size=(batch, components, *shape)).astype(np.float32)
    expected = gather_multi_3d_pallas(
        jnp.asarray(grids), jnp.asarray(normalized), ALL_ORDERS, interpret=True
    )
    actual = cic_kernels.gather_multi_3d_reference(
        torch.from_numpy(grids), torch.from_numpy(normalized), ALL_ORDERS
    )
    assert len(actual) == len(ALL_ORDERS)
    # 8 corner terms of size |grid| <~ 5 per output.
    atol = 8 * F32_EPS * 5
    for order, got, want in zip(ALL_ORDERS, actual, expected):
        assert got.shape == (batch, components, num_particles)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=0, atol=atol, err_msg=str(order)
        )
    # Parked particles gather exactly zero.
    assert torch.all(actual[0][:, :, ::10] == 0)


def test_deposit_and_gather_are_adjoint():
    """<deposit(rows), G> == sum_o <rows_o, gather_o(G)> at float64."""
    rng = np.random.default_rng(12)
    shape = (5, 7, 6)
    normalized = torch.from_numpy(_positions(rng, 2, 400, shape).astype(np.float64))
    rows = torch.from_numpy(rng.normal(size=(2, 8, 3, 400)))
    grids = torch.from_numpy(rng.normal(size=(2, 3, *shape)))
    lhs = torch.sum(cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS) * grids)
    gathered = cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS)
    rhs = sum(torch.sum(rows[:, o] * g) for o, g in enumerate(gathered))
    assert lhs.item() == pytest.approx(rhs.item(), rel=1e-12)


def test_non_finite_positions_weigh_nothing():
    rng = np.random.default_rng(13)
    shape = (4, 4, 4)
    normalized = torch.from_numpy(_positions(rng, 1, 50, shape))
    normalized[0, 3:6] = 1.5  # on the grid, so that dropping them shows
    rows = torch.from_numpy(rng.normal(size=(1, 1, 1, 50)).astype(np.float32))
    clean = cic_kernels.deposit_multi_3d(normalized, rows, shape, cic_kernels.VALUE)
    bad = normalized.clone()
    bad[0, 3] = torch.tensor([float("nan"), 1.0, 1.0])
    bad[0, 4] = torch.tensor([1.0, float("inf"), 1.0])
    bad[0, 5] = torch.tensor([1.0, 1.0, -1e30])
    dropped = rows.clone()
    dropped[..., 3:6] = 0
    expected = cic_kernels.deposit_multi_3d(normalized, dropped, shape, cic_kernels.VALUE)
    actual = cic_kernels.deposit_multi_3d(bad, rows, shape, cic_kernels.VALUE)
    assert torch.isfinite(actual).all()
    torch.testing.assert_close(actual, expected, rtol=0, atol=1e-6)
    assert not torch.equal(clean, actual)
    grids = torch.from_numpy(rng.normal(size=(1, 2, *shape)).astype(np.float32))
    (values,) = cic_kernels.gather_multi_3d(grids, bad, cic_kernels.VALUE)
    assert torch.all(values[..., 3:6] == 0)


def test_charge_deposition_matches_jax_float64():
    rng = np.random.default_rng(14)
    shape = (8, 6, 5)
    positions = rng.normal(size=(3, 2000, 3))
    charges = rng.uniform(0.5, 1.0, size=(3, 2000))
    extent = np.broadcast_to(
        np.array([[-2.5, 2.5], [-2.0, 2.2], [-3.0, 3.0]]), (3, 3, 2)
    ).copy()
    expected = jax_deposition(
        jnp.asarray(positions), shape, jnp.asarray(extent), jnp.asarray(charges)
    )
    actual = cloud_in_cell_charge_deposition(
        torch.from_numpy(positions), shape, torch.from_numpy(extent),
        torch.from_numpy(charges),
    )
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-12)
    # Without an extent, both infer it from the particles' extremes.
    np.testing.assert_allclose(
        cloud_in_cell_charge_deposition(torch.from_numpy(positions), shape).numpy(),
        np.asarray(jax_deposition(jnp.asarray(positions), shape)),
        rtol=1e-12,
        atol=1e-12,
    )
    # Particles outside the extent drop out; in-grid charge is conserved up
    # to the half-cell rim, where corners fall off the grid in both packages.
    assert actual.sum().item() <= charges.sum()
