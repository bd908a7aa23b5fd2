"""The x-tiled pair's plan (``cic_tiled.plan_tiles`` / ``tile_plan``) and its
reuse, on the CPU.

- The tiled plain versions given a precomputed ``plan=`` equal, bit for bit,
  those that make their own, on the shapes and the spilled, parked, NaN and
  inf positions of ``tests/test_torch_cic_tiled.py``.
- The plan's payload: the positions in sorted order are ``normalized``
  gathered by ``perm``, and ``rank`` is the inverse of ``perm``.
- One plan per autograd node: a value_and_grad of the space-charge segment
  on a tiled grid makes 4 plans (one per kick's deposit and gather, in
  forward) and not 10, with the same gradient as without reuse.
- The C entry points' signatures in ``csrc`` against the ctypes argument
  lists the wrappers declare, and each wrapper's card path (its operator's
  CUDA implementation), run on the ``meta`` device with its launch
  intercepted, against those lists.

The card's counting-sort plan is held against ``tile_plan`` exactly by
``chip_smoke.py``; a CUDA kernel has no CPU mode.
"""

import re

import numpy as np
import pytest
import torch

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.ops import cic_common, cic_kernels, cic_tiled, nvcc
from cheetah_tpu_torch.utils import profiling
from test_torch_cic_tiled import ALL_ORDERS, SHAPES, _positions

RAISED = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
#: An H100 SXM's SMs, per-block opt-in shared memory less 1 KB, and shared
#: memory per SM, as ``cic_device_limits`` reports them.
H100_LIMITS = cic_common.DeviceLimits(132, 232448 - 1024, 233472)
ORDER_SETS = {"all": ALL_ORDERS, "value": cic_kernels.VALUE, "raised": RAISED}


def _case(seed, shape, dtype=np.float32, batch=2, num_particles=1777, components=3):
    rng = np.random.default_rng(seed)
    normalized = torch.from_numpy(_positions(rng, batch, num_particles, shape, dtype))
    grids = torch.from_numpy(rng.normal(size=(batch, components, *shape)).astype(dtype))
    return rng, normalized, grids


def _bits(tensor: torch.Tensor) -> torch.Tensor:
    """The bits of a float tensor as integers, so that NaN equals itself."""
    kinds = {torch.float32: torch.int32, torch.float64: torch.int64}
    return tensor.view(kinds[tensor.dtype]) if tensor.dtype in kinds else tensor


@pytest.mark.parametrize("orders", list(ORDER_SETS), ids=list(ORDER_SETS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_with_a_given_plan_are_bit_identical(shape, orders):
    orders = ORDER_SETS[orders]
    rng, normalized, grids = _case(40, shape)
    rows = torch.from_numpy(
        rng.normal(size=(2, len(orders), 2, normalized.shape[1])).astype(np.float32)
    )
    plan = cic_tiled.tile_plan(normalized, shape)
    for given, own in zip(
        cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, orders, plan=plan),
        cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, orders),
    ):
        assert torch.equal(_bits(given), _bits(own))
    assert torch.equal(
        cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, orders, plan=plan),
        cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, orders),
    )
    # The wrappers (CPU tensors: the plain versions) pass the plan on.
    for given, own in zip(
        cic_tiled.gather_multi_tiled_3d(grids, normalized, orders, plan=plan),
        cic_tiled.gather_multi_tiled_3d(grids, normalized, orders),
    ):
        assert torch.equal(_bits(given), _bits(own))
    assert torch.equal(
        cic_tiled.deposit_multi_tiled_3d(normalized, rows, shape, orders, plan=plan),
        cic_tiled.deposit_multi_tiled_3d(normalized, rows, shape, orders),
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES + [(4097, 1, 1), (1024, 1, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_payload_is_the_positions_in_sorted_order(shape, dtype):
    _, normalized, _ = _case(41, shape, dtype, num_particles=999, components=1)
    plan = cic_tiled.plan_tiles(normalized, shape)
    expected = normalized.gather(1, plan.perm[..., None].expand(-1, -1, 3))
    assert plan.sorted_positions.dtype == normalized.dtype
    assert torch.equal(_bits(plan.sorted_positions), _bits(expected))
    places = torch.arange(normalized.shape[1]).expand_as(plan.perm)
    assert torch.equal(plan.rank.gather(1, plan.perm), places)
    assert torch.equal(plan.perm.gather(1, plan.rank), places)
    # Stable: within a tile, the original order.
    for b in range(normalized.shape[0]):
        for t in range(plan.num_tiles):
            run = plan.perm[b, plan.offsets[b, t]:plan.offsets[b, t + 1]]
            assert torch.all(run[1:] > run[:-1])


def test_plan_tiles_runs_tile_plan_on_cpu_and_counts_its_calls():
    _, normalized, _ = _case(42, SHAPES[0], num_particles=300)
    calls, launches = cic_tiled.tile_plan.calls, profiling.counters().get("plan_tiles", 0)
    plan = cic_tiled.plan_tiles(normalized, SHAPES[0])
    plain = cic_tiled.tile_plan(normalized, SHAPES[0])
    assert cic_tiled.tile_plan.calls == calls + 2
    assert profiling.counters().get("plan_tiles", 0) == launches
    for got, want in zip(plan, plain):
        assert torch.equal(_bits(got), _bits(want)) if torch.is_tensor(got) else got == want


def test_a_plan_must_fit_its_positions_and_grid():
    _, normalized, _ = _case(43, SHAPES[0], num_particles=200, components=1)
    plan = cic_tiled.tile_plan(normalized[:, :100], SHAPES[0])
    with pytest.raises(ValueError, match="plan"):
        cic_tiled._check_plan(plan, normalized, SHAPES[0])
    other = cic_tiled.tile_plan(normalized, (200, 200, 8))
    with pytest.raises(ValueError, match="plan"):
        cic_tiled._check_plan(other, normalized, SHAPES[0])
    # A grid of the untiled pair takes no plan.
    untiled = torch.zeros(2, 1, 8, 8, 8, dtype=normalized.dtype)
    with pytest.raises(ValueError, match="tiled pair"):
        cic_kernels.gather_multi_3d(untiled, normalized, cic_kernels.VALUE,
                                    plan=cic_tiled.tile_plan(normalized, SHAPES[0]))


_C_TYPES = {"const void*": "p", "void*": "p", "const int*": "p", "int*": "p", "int64_t": "i64",
            "int": "i32"}
_CTYPES = {"c_void_p": "p", "c_long": "i64", "c_int64": "i64", "c_int": "i32", "c_int32": "i32"}


@pytest.mark.parametrize("library", ["cic", "cic_tiled"])
def test_ctypes_signatures_match_the_c_entry_points(library):
    """Every entry point a wrapper calls exists in f32 and f64 with the
    argument list the wrapper declares (ctypes passes a mistyped pointer or
    int silently)."""
    module = cic_kernels if library == "cic" else cic_tiled
    source = (nvcc.CSRC_DIR / f"{library}.cu").read_text().split('extern "C" {')[1]
    declared = {
        name: [_C_TYPES[" ".join(arg.split()[:-1])] for arg in args.split(",")]
        for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", source, flags=re.M)
    }
    assert set(declared) == {
        f"{name}_{suffix}" for name in module.LIBRARY.functions for suffix in ("f32", "f64")
    } | set(module.LIBRARY.untyped)
    for name, argtypes in module.LIBRARY.functions.items():
        wanted = [_CTYPES[t.__name__] for t in argtypes]
        for suffix in ("f32", "f64"):
            assert declared[f"{name}_{suffix}"] == wanted, (name, suffix)
    for name, argtypes in module.LIBRARY.untyped.items():
        assert declared[name] == [_CTYPES[t.__name__] for t in argtypes], name


# Each operator's CUDA implementation, called as the dispatcher calls it (a
# tiled one on the plan that cic_tile_plan's implementation makes first): on
# the meta device the dispatcher would run the fake implementation instead.
_RAISED, _ALL = cic_common.orders_flat(RAISED), cic_common.orders_flat(ALL_ORDERS)
_TILED = list(SHAPES[0])
_CARD_CALLS = {
    "gather_multi_3d": lambda n, g, r: cic_kernels._gather_kernel(g, n, _RAISED),
    "deposit_multi_3d": lambda n, g, r: cic_kernels._deposit_kernel(n, r, [8, 8, 8], _RAISED),
    "plan_tiles": lambda n, g, r: cic_tiled._plan_kernel(n, _TILED),
    "gather_multi_tiled_3d": lambda n, g, r: cic_tiled._gather_kernel(
        g, n, _ALL, *cic_tiled._plan_kernel(n, _TILED)
    ),
    "deposit_multi_tiled_3d": lambda n, g, r: cic_tiled._deposit_kernel(
        n, r, _TILED, _RAISED, *cic_tiled._plan_kernel(n, _TILED)
    ),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("wrapper", list(_CARD_CALLS))
def test_card_paths_pass_their_signatures(monkeypatch, wrapper, dtype):
    """Each wrapper's card path (its operator's CUDA implementation), run on
    the ``meta`` device with its launch intercepted: the arguments it passes
    match the ctypes argument list in number and kind, it counts its
    launch, and the plan's count scratch holds T * ceil(N / 128) ints per
    instance (cic_tiled.cu's worst case)."""
    calls = []

    def launch(library, name, launch_dtype, device, *args):
        argtypes = library.functions[name][:-1]  # the stream is appended by launch
        assert len(args) == len(argtypes), name
        for arg, kind in zip(args, argtypes):
            assert isinstance(arg, int if kind.__name__ != "c_void_p" else (int, kind)), name
        assert launch_dtype == dtype and device.type == "meta"
        calls.append((name, args))

    for module in (cic_kernels, cic_tiled):
        monkeypatch.setattr(module.LIBRARY, "launch", launch.__get__(module.LIBRARY))
    monkeypatch.setattr(cic_common, "_check_device", lambda *tensors: "meta")
    monkeypatch.setattr(cic_common, "device_limits", lambda library, device: H100_LIMITS)
    batch, num_particles = 2, 1000
    normalized = torch.empty(batch, num_particles, 3, dtype=dtype, device="meta")
    grids = torch.empty(batch, 3, *(SHAPES[0] if "tiled" in wrapper else (8, 8, 8)),
                        dtype=dtype, device="meta")
    rows = torch.empty(batch, 3, 2, num_particles, dtype=dtype, device="meta")
    before = profiling.counters().get(wrapper, 0)
    _CARD_CALLS[wrapper](normalized, grids, rows)
    assert profiling.counters()[wrapper] == before + 1
    names = [name for name, _ in calls]
    if wrapper.endswith("tiled_3d"):
        assert names == ["cic_tile_plan", f"cic_{wrapper.split('_')[0]}_tiled"]
    if "cic_tile_plan" in names:
        args = calls[names.index("cic_tile_plan")][1]
        tiles = -(-SHAPES[0][0] // cic_tiled.rows_per_tile(SHAPES[0]))
        assert args[2] == batch * tiles * -(-num_particles // 128)


def _sc_value_and_grad(grid):
    """sum(px^2) after Drift-Kick-Drift-Kick-Drift and its derivative with
    respect to the first drift's length, float64 on the CPU."""
    kw = {"dtype": torch.float64, "device": "cpu"}
    segment = ctt.Segment([
        ctt.Drift(0.1, **kw), ctt.SpaceChargeKick(0.2, grid_shape=grid, **kw),
        ctt.Drift(0.1, **kw), ctt.SpaceChargeKick(0.2, grid_shape=grid, **kw),
        ctt.Drift(0.1, **kw),
    ])
    beam = ctt.ParticleBeam.from_twiss(
        num_particles=4000, beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9, beta_y=3.0,
        alpha_y=0.5, emittance_y=2e-9, energy=1.54e8, total_charge=1e-10,
        generator=torch.Generator().manual_seed(7), **kw,
    )
    length = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    segment.elements[0].length = length
    value = torch.sum(torch.square(segment.track(beam).px))
    (grad,) = torch.autograd.grad(value, length)
    return value.item(), grad.item()


def test_space_charge_gradient_makes_one_plan_per_autograd_node(monkeypatch):
    grid = (160, 40, 16)
    assert cic_kernels.uses_tiled(grid)
    calls = cic_tiled.tile_plan.calls
    value, grad = _sc_value_and_grad(grid)
    reused = cic_tiled.tile_plan.calls - calls
    # Without reuse every wrapper call makes its own plan: per kick 2 in
    # forward, 3 in backward (the gather's transpose deposit and raised
    # gather, the deposit's raised gather).
    monkeypatch.setattr(cic_kernels, "_node_plan", lambda plan, normalized, shape: None)
    calls = cic_tiled.tile_plan.calls
    value_alone, grad_alone = _sc_value_and_grad(grid)
    alone = cic_tiled.tile_plan.calls - calls
    assert (reused, alone) == (4, 10)
    assert value == value_alone
    assert grad == pytest.approx(grad_alone, rel=1e-12) and grad != 0
