"""The plain PyTorch versions of the x-tiled CIC kernels against the JAX
x-tiled Pallas kernels run in interpret mode (``deposit_multi_tiled_pallas``
and ``gather_multi_tiled_pallas``), at all 8 derivative orders, on the
shapes of ``tests/test_pallas_cic_tiled.py``; against the untiled plain
versions; and the port's dispatch rule against the JAX package's.

The Pallas kernels contract two-hot tiles with float32 matrix products, the
plain versions add corner by corner in the sorted order; in float32 they
agree to the rounding of an f32 sum, K * eps * M for at most K terms of size
M per output, which each test states as its absolute tolerance. In float64
the tiled and untiled plain versions agree to the rounding of the same sums
taken in another order.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_tpu.ops.pallas_cic import _fits_untiled
from cheetah_tpu.ops.pallas_cic_tiled import (
    _pick_rows_per_tile,
    deposit_multi_tiled_pallas,
    gather_multi_tiled_pallas,
    tiled_bounds_ok as jax_tiled_bounds_ok,
)
from cheetah_tpu_torch.ops import cic_kernels, cic_tiled
from cheetah_tpu_torch.utils import profiling

ALL_ORDERS = tuple(itertools.product((0, 1), repeat=3))
F32_EPS = float(np.finfo(np.float32).eps)
F64_EPS = float(np.finfo(np.float64).eps)

# Past the untiled lead bound (nx*ny = 6400 > 4096) but cheap to test.
BIG_SHAPE = (160, 40, 16)
SHAPES = [BIG_SHAPE, (40, 24, 16), (48, 16, 24)]


def _positions(rng, batch, num_particles, shape, dtype=np.float32):
    """Bin-space positions that spill past every edge, with parked (-2) and
    non-finite particles mixed in."""
    normalized = rng.uniform(
        -1.5, np.asarray(shape) + 0.5, size=(batch, num_particles, 3)
    ).astype(dtype)
    normalized[:, ::10] = -2.0
    normalized[:, 1::37, 0] = np.nan
    normalized[:, 2::41, 0] = np.inf
    normalized[:, 3::43, 1] = -np.inf
    normalized[:, 4::47, 0] = -1e30
    return normalized


def test_bounds_and_dispatch():
    """The JAX package's bounds test, for the port's copy of the rule."""
    assert not cic_kernels.fits_untiled(BIG_SHAPE)
    assert cic_tiled.tiled_bounds_ok(BIG_SHAPE)
    assert cic_tiled.tiled_bounds_ok((128, 128, 128))
    assert cic_tiled.tiled_bounds_ok((128, 128, 64))
    assert cic_tiled.tiled_bounds_ok((256, 256, 256))
    assert cic_kernels.fits_untiled((64, 64, 64))
    assert not cic_tiled.tiled_bounds_ok((128, 4096, 64))
    assert not cic_tiled.tiled_bounds_ok((8, 8, 8192))
    assert cic_tiled.rows_per_tile((128, 128, 128)) >= 1
    # The port sends exactly the grids to the tiled kernels that the JAX
    # package sends to its own, and tiles them alike where a window row
    # fits the deposit kernel's shared-memory floor.
    for shape in [BIG_SHAPE, (40, 24, 16), (48, 16, 24), (32, 32, 32), (64, 64, 64),
                  (128, 128, 128), (128, 128, 64), (96, 16, 16), (128, 4096, 64),
                  (8, 8, 8192), (4097, 1, 1), (300, 300, 3)]:
        assert cic_kernels.fits_untiled(shape) == _fits_untiled(shape), shape
        assert cic_tiled.tiled_bounds_ok(shape) == jax_tiled_bounds_ok(shape), shape
        assert cic_kernels.uses_tiled(shape) == (
            not _fits_untiled(shape) and jax_tiled_bounds_ok(shape)
        ), shape
        if jax_tiled_bounds_ok(shape):
            assert cic_tiled.rows_per_tile(shape) == _pick_rows_per_tile(*shape), shape
    assert cic_kernels.uses_tiled((128, 128, 128)) and cic_kernels.uses_tiled(BIG_SHAPE)
    assert not cic_kernels.uses_tiled((32, 32, 32))
    # Where it does not, the port tiles finer: one float64 window row of
    # (R + 1) x nt cells stays within 48 KB.
    assert cic_kernels.uses_tiled((1024, 1, 512)) and _pick_rows_per_tile(1024, 1, 512) == 255
    assert cic_tiled.rows_per_tile((1024, 1, 512)) == 11


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_deposit_reference_matches_pallas_all_orders(shape):
    rng = np.random.default_rng(30)
    batch, components, num_particles = 2, 2, 1777
    normalized = _positions(rng, batch, num_particles, shape)
    rows = rng.normal(size=(batch, len(ALL_ORDERS), components, num_particles)).astype(
        np.float32
    )
    expected = np.asarray(
        deposit_multi_tiled_pallas(
            jnp.asarray(normalized), jnp.asarray(rows), shape, ALL_ORDERS, interpret=True
        )
    )
    actual = cic_tiled.deposit_multi_tiled_3d_reference(
        torch.from_numpy(normalized), torch.from_numpy(rows), shape, ALL_ORDERS
    )
    assert actual.shape == (batch, components, *shape) == expected.shape
    # Each cell sums 8 orders x ~N*8/cells corner terms of |row| <~ 4; at
    # least 8 terms, the corners of one particle.
    terms = max(8, len(ALL_ORDERS) * num_particles * 8 / np.prod(shape))
    np.testing.assert_allclose(actual.numpy(), expected, rtol=0, atol=terms * F32_EPS * 4)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_gather_reference_matches_pallas_all_orders(shape):
    rng = np.random.default_rng(31)
    batch, components, num_particles = 2, 3, 1777
    normalized = _positions(rng, batch, num_particles, shape)
    grids = rng.normal(size=(batch, components, *shape)).astype(np.float32)
    expected = gather_multi_tiled_pallas(
        jnp.asarray(grids), jnp.asarray(normalized), ALL_ORDERS, interpret=True
    )
    actual = cic_tiled.gather_multi_tiled_3d_reference(
        torch.from_numpy(grids), torch.from_numpy(normalized), ALL_ORDERS
    )
    assert len(actual) == len(ALL_ORDERS)
    # 8 corner terms of size |grid| <~ 5 per output.
    for order, got, want in zip(ALL_ORDERS, actual, expected):
        assert got.shape == (batch, components, num_particles)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=0, atol=8 * F32_EPS * 5, err_msg=str(order)
        )
    # Parked and non-finite particles gather exactly zero.
    for index in (slice(None, None, 10), slice(1, None, 37), slice(2, None, 41)):
        assert torch.all(actual[0][:, :, index] == 0)


@pytest.mark.parametrize("shape", SHAPES + [(7, 5, 3), (4097, 1, 1), (1024, 1, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tiled_reference_equals_untiled_reference_f64(shape):
    """The tiled plan computes the untiled function: the same sums in
    another order, so they agree to a few ulps of the largest output."""
    rng = np.random.default_rng(32)
    normalized = torch.from_numpy(_positions(rng, 2, 1500, shape, np.float64))
    rows = torch.from_numpy(rng.normal(size=(2, len(ALL_ORDERS), 3, 1500)))
    grids = torch.from_numpy(rng.normal(size=(2, 3, *shape)))
    # Either pair's wrapper, called directly, takes any grid.
    tiled = cic_tiled.deposit_multi_tiled_3d(normalized, rows, shape, ALL_ORDERS)
    untiled = cic_kernels._deposit_untiled(normalized, rows, shape, ALL_ORDERS)
    assert torch.equal(
        tiled, cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, ALL_ORDERS)
    )
    assert torch.equal(
        untiled, cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, ALL_ORDERS)
    )
    scale = untiled.abs().max().item()
    torch.testing.assert_close(tiled, untiled, rtol=0, atol=64 * F64_EPS * scale)
    tiled = cic_tiled.gather_multi_tiled_3d(grids, normalized, ALL_ORDERS)
    untiled = cic_kernels._gather_untiled(grids, normalized, ALL_ORDERS)
    plain = cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, ALL_ORDERS)
    for got, want in zip(tiled, plain):
        assert torch.equal(got, want)
    for got, want in zip(tiled, untiled):
        torch.testing.assert_close(got, want, rtol=0, atol=16 * F64_EPS * 5)


def test_tiled_reference_handles_clustered_and_empty_tiles():
    """All particles in one x-slab: most tiles hold no particle, their
    windows stay zero, and the total charge is conserved (the JAX test of
    the same name), against the JAX kernel too."""
    shape = BIG_SHAPE
    rng = np.random.default_rng(33)
    num_particles = 2000
    normalized = np.stack(
        [
            rng.uniform(80.2, 83.8, size=(1, num_particles)),
            rng.uniform(0.5, shape[1] - 1.5, size=(1, num_particles)),
            rng.uniform(0.5, shape[2] - 1.5, size=(1, num_particles)),
        ],
        axis=-1,
    ).astype(np.float32)
    charges = np.ones((1, 1, 1, num_particles), np.float32)
    grid = cic_tiled.deposit_multi_tiled_3d_reference(
        torch.from_numpy(normalized), torch.from_numpy(charges), shape, cic_kernels.VALUE
    )[0, 0]
    assert grid.sum().item() == pytest.approx(num_particles, rel=1e-5)
    outside = grid.clone()
    outside[79:86] = 0
    assert outside.abs().max().item() == 0
    expected = np.asarray(
        deposit_multi_tiled_pallas(
            jnp.asarray(normalized), jnp.asarray(charges), shape, cic_kernels.VALUE,
            interpret=True,
        )
    )[0, 0]
    # ~N*8/(4*40*16) ~ 25 terms of size 1 per occupied cell.
    np.testing.assert_allclose(grid.numpy(), expected, rtol=0, atol=64 * F32_EPS)


def test_tiled_reference_single_particle_placement():
    """One particle straddling a tile boundary lands its exact corner
    weights on the right global cells (the JAX test of the same name)."""
    shape = (96, 16, 16)
    normalized = torch.tensor([[[47.75, 3.25, 9.5]]], dtype=torch.float32)
    charges = torch.ones((1, 1, 1, 1), dtype=torch.float32)
    # (96, 16, 16) is within the untiled bound; call the tiled version directly.
    grid = cic_tiled.deposit_multi_tiled_3d_reference(
        normalized, charges, shape, cic_kernels.VALUE
    )[0, 0].numpy()
    for cx, wx in ((47, 0.25), (48, 0.75)):
        for cy, wy in ((3, 0.75), (4, 0.25)):
            for ct, wt in ((9, 0.5), (10, 0.5)):
                assert grid[cx, cy, ct] == pytest.approx(wx * wy * wt, rel=1e-6)
    assert grid.sum() == pytest.approx(1.0, rel=1e-6)
    expected = np.asarray(
        deposit_multi_tiled_pallas(
            jnp.asarray(normalized.numpy()), jnp.asarray(charges.numpy()), shape,
            cic_kernels.VALUE, interpret=True,
        )
    )[0, 0]
    np.testing.assert_allclose(grid, expected, rtol=0, atol=F32_EPS)


def test_tile_plan_sorts_by_tile():
    rng = np.random.default_rng(34)
    normalized = torch.from_numpy(_positions(rng, 2, 999, BIG_SHAPE))
    plan = cic_tiled.tile_plan(normalized, BIG_SHAPE)
    assert plan.rows_per_tile == 5 and plan.num_tiles == 32
    assert torch.all(plan.sorted_tile[:, 1:] >= plan.sorted_tile[:, :-1])
    assert plan.offsets.shape == (2, 33)
    assert torch.all(plan.offsets[:, 0] == 0) and torch.all(plan.offsets[:, -1] == 999)
    counts = plan.offsets.diff(dim=1)
    for b in range(2):
        assert torch.equal(
            counts[b], torch.bincount(plan.sorted_tile[b].long(), minlength=32)
        )
        assert torch.equal(plan.perm[b].sort().values, torch.arange(999))
    # A particle with floor(x) = -1 reaches row 0 from tile 0; NaN sorts
    # into tile 0 and +inf into the last tile, where they weigh nothing.
    x = normalized[..., 0]
    tiles = torch.empty_like(plan.sorted_tile)
    tiles.scatter_(1, plan.perm, plan.sorted_tile)
    assert torch.all(tiles[(x >= -1) & (x < 0)] == 0)
    assert torch.all(tiles[torch.isnan(x)] == 0)
    assert torch.all(tiles[x == float("inf")] == 31)


def test_wrappers_dispatch_tiled_grids_to_the_tiled_plain_versions_on_cpu():
    rng = np.random.default_rng(35)
    normalized = torch.from_numpy(_positions(rng, 1, 500, BIG_SHAPE))
    rows = torch.from_numpy(rng.normal(size=(1, 2, 3, 500)).astype(np.float32))
    grids = torch.from_numpy(rng.normal(size=(1, 3, *BIG_SHAPE)).astype(np.float32))
    orders = ((0, 0, 0), (1, 0, 1))
    names = ("deposit_multi_3d", "gather_multi_3d", "deposit_multi_tiled_3d",
             "gather_multi_tiled_3d")
    counts = [profiling.counters().get(name, 0) for name in names]
    grid = cic_kernels.deposit_multi_3d(normalized, rows, BIG_SHAPE, orders)
    values = cic_kernels.gather_multi_3d(grids, normalized, orders)
    assert counts == [profiling.counters().get(name, 0) for name in names]
    assert torch.equal(
        grid, cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, BIG_SHAPE, orders)
    )
    for got, want in zip(
        values, cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, orders)
    ):
        assert torch.equal(got, want)
    assert cic_tiled.LIBRARY.handle is None and cic_kernels.LIBRARY.handle is None
    with pytest.raises(ValueError, match="bounds"):
        cic_tiled.gather_multi_tiled_3d(
            torch.zeros(1, 1, 8, 8, 8192), torch.zeros(1, 4, 3), cic_kernels.VALUE
        )
