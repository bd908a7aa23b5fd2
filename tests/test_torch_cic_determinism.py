"""The fixed point that makes every deposit repeat bit for bit, on the CPU.

The card's deposits (``csrc/cic_common.cuh``) add every corner value as an
integer: a window in shared memory as int32 (the value order set in
float32) or int64, a grid in global memory as int64 at one power-of-two
scale per (instance, component) from its largest |row|; in a global grid
non-finite terms set a cell's poison bits. Here, without a card:

- the scale against its stated rounding bound, worked in numpy the way the
  kernels work it (a power of two from the largest |row|, each term rounded
  to the nearest unit, int64 sums, one conversion back), against the plain
  deposit in float64;
- the scratch and shared-memory sizes the wrappers compute
  (``fixed_scratch_bytes``, ``window_bytes``, the tiled stage) against
  their budgets and the C source's constants;
- the wrappers' card paths on the ``meta`` device, their launches
  intercepted: each route gets its scratch and the scratch's size;
- ``fixed_point_index_add``, the screens' sum, against ``index_add`` and the
  JAX package's screen, in any order of its terms, with its gradients;
- ``track_checkpointed`` equal to ``track`` bit for bit on the space-charge
  line (the plain versions on the CPU, as the kernels on the card).
"""

import math
import re

import numpy as np
import pytest
import torch

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.ops import cic_common, cic_kernels, cic_tiled, nvcc
from cheetah_tpu_torch.ops.cloud_in_cell import fixed_point_index_add
from test_torch_cic_plan import H100_LIMITS, RAISED
from test_torch_diagnostics import _jax_beam, _jax_screen, _screen_to_torch, assert_image_close
from test_torch_parameter_beam import jit_call
from test_torch_tracking import beam_to_torch

ORDER_SETS = {"value": cic_kernels.VALUE, "raised": RAISED}


# ---------------------------------------------------------------------------
# The scale and its rounding bound
# ---------------------------------------------------------------------------


def _fixed_point_deposit(normalized, rows, shape, orders):
    """The int64 grids' arithmetic in numpy: per (instance, component) the
    bound S = N O M (M the largest |row|), the scale 2^e with
    e = 60 - ilogb(N O) - ilogb(M), each corner term rounded to the nearest
    unit, int64 sums, one conversion back. Returns the grid and S per grid."""
    flat = np.zeros((rows.shape[0], rows.shape[2], math.prod(shape)), dtype=np.int64)
    terms = rows.shape[1] * rows.shape[3]
    largest = np.abs(rows).max(axis=(1, 3))
    exponent = 60 - (np.frexp(float(terms))[1] - 1) - (np.frexp(largest)[1] - 1)
    scale = np.ldexp(1.0, exponent)[..., None]
    for cell, valid, weights in cic_common._corner_terms(
        torch.from_numpy(normalized), shape, orders
    ):
        terms_ = sum(rows[:, o] * weights[o][:, None, :].numpy() for o in range(len(orders)))
        units = np.rint(np.where(valid[:, None, :].numpy(), terms_, 0.0) * scale).astype(np.int64)
        for b in range(rows.shape[0]):
            for c in range(rows.shape[2]):
                np.add.at(flat[b, c], cell[b].numpy(), units[b, c])
    return flat / scale, terms * largest


def _touches(normalized, shape):
    """The most particles that touch one cell: the terms of a cell's sum."""
    counts = np.zeros(normalized.shape[0] * math.prod(shape), dtype=np.int64)
    base = np.arange(normalized.shape[0])[:, None] * math.prod(shape)
    for cell, valid, _ in cic_common._corner_terms(torch.from_numpy(normalized), shape,
                                                   cic_kernels.VALUE):
        np.add.at(counts, (base + cell.numpy())[valid.numpy()], 1)
    return counts.max()


@pytest.mark.parametrize("orders", list(ORDER_SETS))
@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 10, 6)])
def test_int64_scale_keeps_every_cell_within_its_rounding_bound(shape, orders):
    """An int64 grid's scale 2^e puts S = N O M in [2^60, 2^62): each of a
    cell's K terms rounds by at most half a unit, S 2^-61, the int64 sums
    stay below 2^62 + K / 2 < 2^63, and the result is within K S 2^-61 of
    the plain float64 deposit (plus the plain sum's own float64 rounding, K
    eps64 times the cell's sum of |terms|, at most S)."""
    rng = np.random.default_rng(12)
    n = np.asarray(shape, dtype=np.float64)
    normalized = n / 2 - 0.5 + rng.normal(size=(2, 3000, 3)) * n / 5
    orders = ORDER_SETS[orders]
    rows = rng.normal(size=(2, len(orders), 3, 3000)) * np.array([1.0, 1e-3, 1e5])[:, None]
    fixed, bounds = _fixed_point_deposit(normalized, rows, shape, orders)
    plain = cic_kernels.deposit_multi_3d_reference(
        torch.from_numpy(normalized), torch.from_numpy(rows), shape, orders
    ).reshape(fixed.shape).numpy()
    terms = _touches(normalized, shape)
    bound = terms * bounds[..., None] * (2.0**-61 + 2.0**-52)
    assert np.all(np.abs(fixed - plain) <= bound)
    # The scale's headroom: S * scale in [2^60, 2^62).
    largest = np.abs(rows).max(axis=(1, 3))
    count = len(orders) * 3000
    scale = np.ldexp(1.0, 60 - (np.frexp(float(count))[1] - 1) - (np.frexp(largest)[1] - 1))
    assert np.all((bounds * scale >= 2.0**60) & (bounds * scale < 2.0**62))


def test_int32_window_scale_rounds_within_2_to_the_minus_17_of_the_largest_row():
    """An int32 window holds at most MAX_WINDOW_PARTICLES particles at scale
    2^30 / S: a term rounds by half a unit, S * 2^-31 <= MAX_WINDOW_PARTICLES
    * max|row| * 2^-31 = 2^-17 of the largest row, plus the float32 product
    v * scale's own rounding (eps32 / 2 of the term), and the window's sums
    stay below int32's 2^31."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=cic_common.MAX_WINDOW_PARTICLES).astype(np.float32)
    total = np.abs(rows.astype(np.float64)).sum()
    scale = np.float32(2.0**30 / total)
    units = np.rint(rows * scale).astype(np.int64)
    assert np.abs(units).sum() < 2**31
    error = np.abs(units / np.float64(scale) - rows).max()
    largest = np.abs(rows).max()
    assert error <= total * 2.0**-31 + largest * 2.0**-24
    assert total * 2.0**-31 <= largest * 2.0**-17


def test_c_source_states_the_same_scales():
    header = (nvcc.CSRC_DIR / "cic_common.cuh").read_text()
    assert "60 - ilogb(terms) - ilogb(m)" in header  # an int64 grid: 2^e N O M < 2^62
    assert "pow2(61 - ilogb(s))" in header  # an int64 window: 2^e S < 2^62
    assert "1073741824.0 / total" in header  # 2^30 / S for an int32 window


# ---------------------------------------------------------------------------
# Scratch and shared memory against their budgets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [(1, 128**3), (3, 128**3), (4, 64**3), (70_000, 64), (1, 1)])
def test_fixed_scratch_holds_grids_poison_bits_and_maxima(case):
    """The int64 grids, 2 poison bits a cell and each grid's largest |row|
    (float64 bits), in 8-byte words, as the C source carves them."""
    grids, cells = case
    words = grids * cells + math.ceil(grids * cells * 2 / 64) + grids
    assert cic_common.fixed_scratch_bytes(grids, cells) == 8 * words
    header = (nvcc.CSRC_DIR / "cic_common.cuh").read_text()
    assert "return 8 * (values + (values + 31) / 32 + grids);" in header
    # At the 128^3 path's shape: 16 MB of int64 cells and 0.5 MB of poison bits.
    if case == (1, 128**3):
        assert cic_common.fixed_scratch_bytes(*case) < 16.6 * 2**20


@pytest.mark.parametrize("values", [1, 3, 4, 5, 32768, 3840])
@pytest.mark.parametrize("accumulator", [4, 8])
def test_window_bytes_hold_the_cells_on_16_byte_boundaries(values, accumulator):
    size = cic_common.window_bytes(values, accumulator)
    assert size % 16 == 0 and values * accumulator <= size < values * accumulator + 16
    assert cic_common.window_bytes(values, accumulator, 100) == size + 100


def test_stage_matches_the_c_source():
    source = (nvcc.CSRC_DIR / "cic_tiled.cu").read_text()
    (cells,) = re.findall(r"constexpr int kStageCells = (\d+);", source)
    assert cic_common.STAGE_BYTES == 2 * int(cells) * 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("orders", list(ORDER_SETS))
def test_accumulator_is_int32_only_for_the_value_order_set_in_float32(dtype, orders):
    expected = 4 if (dtype, orders) == (torch.float32, "value") else 8
    assert cic_common.accumulator_bytes(dtype, ORDER_SETS[orders]) == expected


@pytest.mark.parametrize("components", [1, 3])
@pytest.mark.parametrize("accumulator", [4, 8])
def test_tiled_windows_and_their_stage_fit_a_block(components, accumulator):
    """At 128^3 (R = 1, two-row windows): an int32 window (128 KB) fits
    beside its 64 KB stage; an int64 window (256 KB) does not fit, and every
    corner goes to the int64 grids directly."""
    window = 2 * 128 * 128
    geometry = cic_tiled.tiled_deposit_geometry(1, components, 1_000_000, window, accumulator,
                                                H100_LIMITS)
    if accumulator == 8:
        assert (geometry.group, geometry.shared) == (components, 0)
        return
    assert geometry.group == 1
    assert geometry.shared == 128 * 1024 + cic_common.STAGE_BYTES <= H100_LIMITS.budget


def test_untiled_int64_window_of_32_cubed_does_not_fit_and_16_cubed_does():
    assert cic_kernels.untiled_deposit_geometry(1, 1, 10**6, 32**3, 8, H100_LIMITS) is None
    geometry = cic_kernels.untiled_deposit_geometry(1, 3, 10**6, 16**3, 8, H100_LIMITS)
    assert geometry.group == 3
    assert geometry.shared == cic_common.window_bytes(3 * 16**3, 8) <= H100_LIMITS.budget


# ---------------------------------------------------------------------------
# The wrappers hand each route its scratch
# ---------------------------------------------------------------------------

_ROUTES = {
    # name: (shape, dtype, orders, components, batch, route)
    "32^3_f32_value": ((32, 32, 32), torch.float32, "value", 1, 1, "private"),
    "32^3_f32_raised": ((32, 32, 32), torch.float32, "raised", 3, 1, "global"),
    "16^3_f32_raised": ((16, 16, 16), torch.float32, "raised", 3, 2, "private"),
    "32^3_f64_value": ((32, 32, 32), torch.float64, "value", 1, 4, "global"),
    "64^3_f32_value": ((64, 64, 64), torch.float32, "value", 3, 1, "global"),
    "128^3_f32_value": ((128, 128, 128), torch.float32, "value", 1, 1, "tiled"),
    "128^3_f64_raised": ((128, 128, 128), torch.float64, "raised", 1, 2, "tiled"),
}


@pytest.mark.parametrize("name", list(_ROUTES))
def test_card_paths_pass_each_route_its_scratch(monkeypatch, name):
    """The deposits' CUDA implementations on the ``meta`` device, their
    launches intercepted: the privatised route gets the (B, C, copies,
    cells) scratch of T, the global and tiled routes an int64 scratch of
    ``fixed_scratch_bytes``, each with its size in bytes; nothing is zeroed
    on the host (the kernels zero what they add into)."""
    shape, dtype, orders, components, batch, route = _ROUTES[name]
    orders = ORDER_SETS[orders]
    calls, allocated = [], []

    def launch(library, entry, launch_dtype, device, *args):
        calls.append((entry, args))

    for module in (cic_kernels, cic_tiled):
        monkeypatch.setattr(module.LIBRARY, "launch", launch.__get__(module.LIBRARY))
    monkeypatch.setattr(cic_common, "_check_device", lambda *tensors: "meta")
    monkeypatch.setattr(cic_common, "device_limits", lambda library, device: H100_LIMITS)
    particles = 1_000_000
    normalized = torch.empty(batch, particles, 3, dtype=dtype, device="meta")
    rows = torch.empty(batch, len(orders), components, particles, dtype=dtype, device="meta")
    flat = cic_common.orders_flat(orders)
    cells = math.prod(shape)
    plan = cic_tiled._plan_kernel(normalized, list(shape)) if route == "tiled" else ()
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocated.append(real_empty(*a, **k))
                        or allocated[-1])
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: pytest.fail("zeroed on the host"))
    if route == "tiled":
        cic_tiled._deposit_kernel(normalized, rows, list(shape), flat, *plan)
        (entry, args), size = calls[-1], calls[-1][1][6]
        assert entry == "cic_deposit_tiled"
    else:
        cic_kernels._deposit_kernel(normalized, rows, list(shape), flat)
        (entry, args), size = calls[-1], calls[-1][1][4]
        assert entry == "cic_deposit_multi" and (args[11] > 0) == (route == "private")
    scratch = allocated[-1]
    assert size == scratch.numel() * scratch.element_size()
    if route == "private":
        copies = args[12]
        assert scratch.dtype == dtype and copies > 1
        assert size == batch * components * copies * cells * scratch.element_size()
    else:
        assert scratch.dtype == torch.int64
        assert size == cic_common.fixed_scratch_bytes(batch * components, cells)


# ---------------------------------------------------------------------------
# The screens' sum
# ---------------------------------------------------------------------------


def _terms(rng, count, size, dtype=torch.float64):
    index = torch.from_numpy(rng.integers(0, size, count))
    source = torch.from_numpy(rng.normal(size=count) * rng.uniform(0, 10, count)).to(dtype)
    return index, source


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_point_index_add_is_index_add_within_its_bound_in_any_order(dtype):
    rng = np.random.default_rng(5)
    index, source = _terms(rng, 20_000, 300, dtype)
    got = fixed_point_index_add(index, source, 300)
    want = torch.zeros(300, dtype=torch.float64).index_add(0, index, source.double())
    total = source.double().abs().sum().item()
    counts = torch.bincount(index, minlength=300).double()
    bound = counts * total * 2.0**-62 + torch.finfo(dtype).eps * want.abs() + 1e-300
    assert got.dtype == dtype
    assert torch.all((got.double() - want).abs() <= bound + counts * 2.0**-52 * total)
    for seed in range(3):
        order = torch.from_numpy(np.random.default_rng(seed).permutation(index.numel()))
        shuffled = fixed_point_index_add(index[order], source[order], 300)
        assert torch.equal(shuffled, got)


def test_fixed_point_index_add_sums_non_finite_terms_as_floats_do():
    index = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3, 4])
    inf, nan = float("inf"), float("nan")
    source = torch.tensor([inf, 1.0, -inf, 2.0, inf, -inf, nan, 5.0, 3.0])
    got = fixed_point_index_add(index, source, 6)
    want = torch.zeros(6).index_add(0, index, source)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    finite = ~torch.isnan(want)
    assert torch.equal(got[finite], want[finite])


def test_fixed_point_index_add_gradients():
    rng = np.random.default_rng(8)
    index, source = _terms(rng, 200, 17)
    source.requires_grad_()
    torch.autograd.gradcheck(lambda s: fixed_point_index_add(index, s, 17), (source,))
    tangent = torch.from_numpy(rng.normal(size=200))
    _, jvp = torch.func.jvp(lambda s: fixed_point_index_add(index, s, 17), (source.detach(),),
                            (tangent,))
    assert torch.allclose(jvp, torch.zeros(17, dtype=torch.float64).index_add(0, index, tangent),
                          rtol=1e-13, atol=1e-13)
    batched = torch.func.vmap(lambda s: fixed_point_index_add(index, s, 17))(
        torch.stack([source.detach(), tangent])
    )
    assert torch.equal(batched[1], fixed_point_index_add(index, tangent, 17))


@pytest.mark.parametrize("method", ["histogram", "cloud-in-cell"])
def test_screen_repeats_under_a_permutation_and_matches_the_jax_package(method):
    """A screen's image of a beam and of the same beam with its particles
    permuted: equal bit for bit in the port (its sum does not depend on the
    order of its terms), and within float64 rounding of the JAX package's
    image."""
    jax_beam = _jax_beam(3000)
    jax_screen = _jax_screen(method=method)
    expected = jit_call(lambda s, b: s.observe(b), jax_screen, jax_beam)
    beam = beam_to_torch(jax_beam)
    order = torch.from_numpy(np.random.default_rng(4).permutation(beam.particles.shape[-2]))
    images = []
    for particles in (beam.particles, beam.particles[..., order, :]):
        screen = _screen_to_torch(jax_screen)
        screen.track(interop.particle_beam_from_numpy(
            particles.numpy(), beam.energy.numpy(),
            beam.particle_charges[..., order].numpy() if images else
            beam.particle_charges.numpy(),
            beam.survival_probabilities[..., order].numpy() if images else
            beam.survival_probabilities.numpy(),
            species_name=beam.species.name, device="cpu",
        ))
        images.append(screen.reading)
    assert torch.equal(images[0], images[1])
    assert_image_close(images[0], expected, err_msg=method)


# ---------------------------------------------------------------------------
# track_checkpointed equals track
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", [(64, 64, 64), (128, 128, 128)])
def test_checkpointed_gradient_equals_track_bit_for_bit(grid, dtype):
    """The space-charge line (two kicks, 2000 particles of the cold beam):
    value_and_grad of sum(px^2) by the first drift's length through
    ``track_checkpointed`` equals ``track``'s bit for bit, since it runs the
    same operations on the same values again (64^3 on the untiled plain
    versions, 128^3 on the tiled ones)."""
    beam, line = ctt.lattices.cold_beam_line(2, grid, 2000, dtype, "cpu",
                                             torch.Generator().manual_seed(0))
    results = []
    for method in ("track", "track_checkpointed"):
        length = line.elements[0].length.detach().clone().requires_grad_()
        line.elements[0].length = length
        value = torch.sum(torch.square(getattr(line, method)(beam).px))
        (grad,) = torch.autograd.grad(value, length)
        results.append((value.item(), grad.item()))
    assert results[0] == results[1]
    assert results[0][1] != 0.0
