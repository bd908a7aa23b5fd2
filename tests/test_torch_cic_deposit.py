"""The CIC deposits on the CPU: their plain versions against the Pallas
deposits at the backward shape and on a crowded beam, and the launch
geometry the wrappers compute for the card's kernels.

- ``deposit_multi_3d_reference`` and ``deposit_multi_tiled_3d_reference``
  (given a ``plan=`` and making their own) against ``deposit_multi_3d_pallas``
  and ``deposit_multi_tiled_pallas`` in interpret mode, at C = 3 (the
  transpose of the force gather) with the value and the raised order sets,
  on a Gaussian beam with spilled and parked particles and on a crowded
  one (every particle in the 2 x 2 x 2 cells at the grid's centre).
- The geometry of the privatised deposits
  (``cic_common.components_per_block``, ``cic_common.window_blocks``,
  ``cic_kernels.untiled_deposit_geometry``,
  ``cic_tiled.tiled_deposit_geometry``) against the budgets they state: a
  block's shared memory, whole waves of resident blocks, the fixed point's
  bound on particles a copy or chunk, the grid's y dimension; and the
  wrappers' card paths pass it to the kernels.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against these plain versions on every route the geometry picks.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_tpu.ops.pallas_cic import deposit_multi_3d_pallas
from cheetah_tpu.ops.pallas_cic_tiled import deposit_multi_tiled_pallas
from cheetah_tpu_torch.ops import cic_common, cic_kernels, cic_tiled, nvcc
from test_torch_cic_plan import H100_LIMITS, RAISED

F32_EPS = float(np.finfo(np.float32).eps)
ORDER_SETS = {"value": cic_kernels.VALUE, "raised": RAISED}
UNTILED_SHAPE = (12, 10, 8)
TILED_SHAPE = (160, 40, 16)
NUM_PARTICLES = 1500


def _beam(rng, shape, crowded: bool):
    """(1, N, 3) bin-space positions: a Gaussian beam on +-3 sigma with a
    share spilling past the edges and a tenth parked at -2, as the JAX
    package parks masked and non-finite particles before its untiled
    kernel; or, crowded, every particle inside the 2 x 2 x 2 cells at the
    centre."""
    n = np.asarray(shape, dtype=np.float64)
    if crowded:
        positions = np.floor(n / 2) - 1 + 2 * rng.uniform(size=(1, NUM_PARTICLES, 3))
    else:
        positions = n / 2 - 0.5 + rng.normal(size=(1, NUM_PARTICLES, 3)) * n / 6
        positions[:, ::13] = rng.uniform(-1.5, n + 0.5, size=positions[:, ::13].shape)
        positions[:, 1::10] = -2.0
    return positions.astype(np.float32)


@pytest.mark.parametrize("beam", ["gauss", "crowded"])
@pytest.mark.parametrize("orders", list(ORDER_SETS))
@pytest.mark.parametrize("pair", ["untiled", "tiled_given_plan", "tiled_own_plan"])
def test_deposit_reference_matches_pallas_at_the_backward_shape(pair, orders, beam):
    shape = UNTILED_SHAPE if pair == "untiled" else TILED_SHAPE
    assert cic_kernels.uses_tiled(shape) == (pair != "untiled")
    orders = ORDER_SETS[orders]
    rng = np.random.default_rng(50)
    normalized = _beam(rng, shape, beam == "crowded")
    rows = rng.normal(size=(1, len(orders), 3, NUM_PARTICLES)).astype(np.float32)
    pallas = deposit_multi_3d_pallas if pair == "untiled" else deposit_multi_tiled_pallas
    expected = np.asarray(
        pallas(jnp.asarray(normalized), jnp.asarray(rows), shape, orders, interpret=True)
    )
    positions, values = torch.from_numpy(normalized), torch.from_numpy(rows)
    if pair == "untiled":
        actual = cic_kernels.deposit_multi_3d_reference(positions, values, shape, orders)
    else:
        plan = cic_tiled.tile_plan(positions, shape) if pair == "tiled_given_plan" else None
        actual = cic_tiled.deposit_multi_tiled_3d_reference(
            positions, values, shape, orders, plan=plan
        )
        # The wrapper (CPU tensors: the plain version) agrees bit for bit.
        assert torch.equal(
            actual, cic_kernels.deposit_multi_3d(positions, values, shape, orders, plan=plan)
        )
    assert actual.shape == (1, 3, *shape) == expected.shape
    assert np.isfinite(actual.numpy()).all()
    # A cell sums at most N terms per order (all of them, on the crowded
    # beam) of |row| * weight, each rounded once: K * eps * max|term|.
    terms = NUM_PARTICLES * len(orders)
    atol = terms * F32_EPS * np.abs(rows).max()
    np.testing.assert_allclose(actual.numpy(), expected, rtol=0, atol=atol)
    # The charge that lands on the grid is the same.
    np.testing.assert_allclose(actual.numpy().sum(), expected.sum(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------

# (values per window, accumulator bytes, components) -> components a block
# holds: the path's grids and windows and the checks' routes.
PER_BLOCK_CASES = {
    "32^3_f32_c1": ((32**3, 4, 1), 1), "32^3_f32_c3": ((32**3, 4, 3), 1),
    "32^3_f64_c3": ((32**3, 8, 3), 0), "64^3_f32_c1": ((64**3, 4, 1), 0),
    "8^3_f32_c5": ((8**3, 4, 5), 5), "12x10x8_f32_c300": ((960, 4, 300), 60),
    "window_128^3_f32": ((2 * 128 * 128, 4, 3), 1),
    "window_128^3_f64": ((2 * 128 * 128, 8, 1), 0),
    "window_8x256x512_f32": ((2 * 256 * 512, 4, 1), 0),
    "window_1024x1x512_f64": ((12 * 512, 8, 1), 1),
}


@pytest.mark.parametrize("case", list(PER_BLOCK_CASES))
def test_components_per_block_fill_the_budget(case):
    (values, itemsize, components), expected = PER_BLOCK_CASES[case]
    budget = H100_LIMITS.budget
    group = cic_common.components_per_block(values, itemsize, components, budget)
    assert group == expected
    assert cic_common.window_bytes(group * values, itemsize) <= budget
    # As many as fit.
    assert group == components or cic_common.window_bytes((group + 1) * values, itemsize) > budget


def test_resident_blocks_count_what_an_sm_holds():
    limits = H100_LIMITS
    # 128 KB a block: one per SM; 48 KB: four (the threads' limit).
    assert cic_common.resident_blocks(128 * 1024, limits) == limits.sms
    assert cic_common.resident_blocks(48 * 1024, limits) == 4 * limits.sms
    assert cic_common.resident_blocks(0, limits) == 4 * limits.sms
    for shared in (0, 1024, 48 * 1024, 100 * 1024, 128 * 1024, limits.budget):
        per_sm = cic_common.resident_blocks(shared, limits) // limits.sms
        assert per_sm * cic_common.DEPOSIT_THREADS <= 2048
        assert per_sm == 1 or per_sm * (shared + 1024) <= limits.sm_shared


@pytest.mark.parametrize("particles", [1, 16384, 1_000_000, 3_000_000, 4_000_000, 100_000_000])
def test_window_blocks_are_whole_waves_within_the_fixed_point_bound(particles):
    shared = 128 * 1024
    resident = cic_common.resident_blocks(shared, H100_LIMITS)
    blocks = cic_common.window_blocks(particles, H100_LIMITS, shared)
    needed = -(-particles // cic_common.MAX_WINDOW_PARTICLES)
    assert blocks % resident == 0 and needed <= blocks < needed + resident


UNTILED_CASES = [
    (1, 1, 1_000_000, (32, 32, 32), 4), (1, 3, 1_000_000, (32, 32, 32), 4),
    (4, 1, 1_000_000, (32, 32, 32), 4), (1, 3, 1_000_000, (32, 32, 32), 8),
    (1, 1, 1_000_000, (64, 64, 64), 4), (1, 2, 24, (8, 7, 6), 8),
    (70_000, 1, 8, (4, 4, 4), 4), (1, 1, 1_000_000, (128, 128, 128), 4),
    (100, 1, 1_000_000, (32, 32, 32), 4),
]


@pytest.mark.parametrize("case", UNTILED_CASES, ids=lambda c: f"B{c[0]}_C{c[1]}_N{c[2]}_"
                         + "x".join(map(str, c[3])) + f"_{8 * c[4]}bit")
def test_untiled_geometry_fills_the_card_within_budget(case):
    batch, components, num_particles, shape, itemsize = case
    cells = math.prod(shape)
    geometry = cic_kernels.untiled_deposit_geometry(
        batch, components, num_particles, cells, itemsize, H100_LIMITS
    )
    group = cic_common.components_per_block(cells, itemsize, components, H100_LIMITS.budget)
    if group == 0 or -(-components // group) * batch > 65535:
        # deposit_multi_kernel's global atomics: 32^3 f64, 64^3, 128^3, and
        # 70000 instances of one component (past the grid's y dimension).
        assert geometry is None
        return
    assert geometry.group == group
    assert geometry.shared == cic_common.window_bytes(group * cells, itemsize) <= H100_LIMITS.budget
    groups = -(-components // group)
    blocks = geometry.copies * groups * batch
    allowed = cic_common.window_blocks(batch * groups * num_particles, H100_LIMITS,
                                       geometry.shared)
    assert geometry.copies == 1 or blocks <= allowed
    # No copy takes more particles than its fixed point's bound allows, and
    # none takes fewer than MIN_COPY_PARTICLES unless that bound asks for it.
    assert -(-num_particles // geometry.copies) <= cic_common.MAX_WINDOW_PARTICLES
    assert geometry.copies <= max(1, num_particles // cic_kernels.MIN_COPY_PARTICLES,
                                  -(-num_particles // cic_common.MAX_WINDOW_PARTICLES))
    if num_particles >= 100_000:
        # At least half the card at the path's shapes.
        assert 2 * blocks >= cic_common.resident_blocks(geometry.shared, H100_LIMITS)
    assert (
        cic_kernels.untiled_deposit_geometry(1, 1, 1_000_000, 32**3, 4, H100_LIMITS)
        == (1, 132, 128 * 1024)
    )


TILED_CASES = [
    (1, 1, 1_000_000, (128, 128, 128), 4), (64, 1, 1_000_000, (128, 128, 128), 4),
    (1, 3, 1_000_000, (128, 128, 128), 4), (4, 1, 1_000_000, (128, 128, 128), 4),
    (1, 1, 1_000_000, (128, 128, 128), 8), (1, 1, 1_000_000, (1024, 1, 512), 8),
    (1, 1, 1_000_000, (8, 256, 512), 8), (2, 3, 1777, (160, 40, 16), 4),
]


@pytest.mark.parametrize("case", TILED_CASES, ids=lambda c: f"B{c[0]}_C{c[1]}_N{c[2]}_"
                         + "x".join(map(str, c[3])) + f"_{8 * c[4]}bit")
def test_tiled_geometry_sizes_chunks_and_windows_within_budget(case):
    batch, components, num_particles, shape, itemsize = case
    assert cic_kernels.uses_tiled(shape)
    window = (cic_tiled.rows_per_tile(shape) + 1) * shape[1] * shape[2]
    group, per_run, min_window_run, shared = cic_tiled.tiled_deposit_geometry(
        batch, components, num_particles, window, itemsize, H100_LIMITS
    )
    # As many windows as fit a block's shared memory beside an int32
    # window's stage, or none, and then one block takes every component.
    stage = cic_common.STAGE_BYTES if itemsize == 4 else 0
    fits = cic_common.components_per_block(window, itemsize, components, H100_LIMITS.budget,
                                           stage)
    if fits == 0:
        assert (group, shared) == (components, 0)
    else:
        assert group == fits
        assert shared == cic_common.window_bytes(group * window, itemsize, stage)
        assert shared <= H100_LIMITS.budget
    assert cic_tiled.MIN_DEPOSIT_RUN <= per_run <= cic_common.MAX_WINDOW_PARTICLES
    # Chunks, one a block, as many as whole waves of resident blocks allow
    # (one more per instance and group for the ragged end).
    groups = -(-components // group)
    blocks = -(-num_particles // per_run) * groups * batch
    allowed = cic_common.window_blocks(batch * groups * num_particles, H100_LIMITS, shared)
    assert per_run == cic_tiled.MIN_DEPOSIT_RUN or blocks <= allowed + groups * batch
    assert min_window_run == -(-window // cic_tiled.WINDOW_CELLS_PER_RUN_PARTICLE)
    if shape == (128, 128, 128) and (batch, components, itemsize) == (1, 1, 4):
        assert (group, per_run, min_window_run) == (1, 7576, 2048)


def test_deposit_threads_match_the_c_source():
    header = (nvcc.CSRC_DIR / "cic_common.cuh").read_text()
    (threads,) = re.findall(r"constexpr int kDepositThreads = (\d+);", header)
    assert int(threads) == cic_common.DEPOSIT_THREADS
    (reserve,) = re.findall(r"out\[1\] = optin - (\d+);", header)
    assert H100_LIMITS.budget == 232448 - int(reserve)


@pytest.mark.parametrize("case", ["32^3_f32", "32^3_f32_c3", "64^3_f64", "128^3_f32_c3",
                                  "8x256x512_f64"])
def test_card_paths_pass_the_geometry(monkeypatch, case):
    """The deposits' card paths (their operators' CUDA implementations) on
    the ``meta`` device, their launches intercepted: each passes the geometry the wrapper computed, allocates
    the untiled scratch of (B, C, copies, cells) values when it has several
    copies and the int64 grids' scratch (``fixed_scratch_bytes``) where it
    adds into them, passes the scratch's size, and zeroes nothing itself
    (the kernels zero their scratch and write every output cell)."""
    shapes = {"32^3": (32, 32, 32), "64^3": (64, 64, 64), "128^3": (128, 128, 128),
              "8x256x512": (8, 256, 512)}
    shape = shapes[case.split("_")[0]]
    dtype = torch.float64 if "f64" in case else torch.float32
    components = 3 if case.endswith("c3") else 1
    calls = []

    def launch(library, name, launch_dtype, device, *args):
        assert len(args) == len(library.functions[name]) - 1, name
        calls.append((name, args))

    for module in (cic_kernels, cic_tiled):
        monkeypatch.setattr(module.LIBRARY, "launch", launch.__get__(module.LIBRARY))
    monkeypatch.setattr(cic_common, "_check_device", lambda *tensors: "meta")
    monkeypatch.setattr(cic_common, "device_limits", lambda library, device: H100_LIMITS)
    zeros = []
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: zeros.append(a) or real_zeros(*a, **k))
    num_particles = 1_000_000
    normalized = torch.empty(1, num_particles, 3, dtype=dtype, device="meta")
    rows = torch.empty(1, 1, components, num_particles, dtype=dtype, device="meta")
    # The CUDA implementation of the operator that deposit_multi_3d
    # dispatches to (on the meta device the dispatcher would run the fake).
    flat = cic_common.orders_flat(cic_kernels.VALUE)
    if cic_kernels.uses_tiled(shape):
        plan = cic_tiled._plan_kernel(normalized, list(shape))
        out = cic_tiled._deposit_kernel(normalized, rows, list(shape), flat, *plan)
    else:
        out = cic_kernels._deposit_kernel(normalized, rows, list(shape), flat)
    assert out.shape == (1, components, *shape) and out.dtype == dtype
    itemsize = torch.empty((), dtype=dtype).element_size()
    name, args = calls[-1]
    if cic_kernels.uses_tiled(shape):
        assert name == "cic_deposit_tiled"
        window = (cic_tiled.rows_per_tile(shape) + 1) * shape[1] * shape[2]
        geometry = cic_tiled.tiled_deposit_geometry(
            1, components, num_particles, window, itemsize, H100_LIMITS
        )
        # The C entry point's order: per_run, group, min_window_run.
        assert args[15:18] == (geometry.per_run, geometry.group, geometry.min_window_run)
        assert args[6] == cic_common.fixed_scratch_bytes(components, math.prod(shape))
        assert not zeros
        return
    assert name == "cic_deposit_multi"
    geometry = cic_kernels.untiled_deposit_geometry(
        1, components, num_particles, math.prod(shape), itemsize, H100_LIMITS
    )
    group, copies = args[11:13]
    assert not zeros and isinstance(args[3], int)
    if geometry is None:
        assert (group, copies) == (0, 1)
        assert args[4] == cic_common.fixed_scratch_bytes(components, math.prod(shape))
    else:
        assert (group, copies) == geometry[:2] and copies > 1
        assert args[4] == components * copies * math.prod(shape) * itemsize
