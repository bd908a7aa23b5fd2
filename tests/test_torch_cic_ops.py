"""The five CIC kernel entry points as ``torch.library`` operators (the
counterpart of the JAX package's primitives, ``pallas_cic.py:536-750``), on
the CPU.

- ``torch.library.opcheck`` on each operator (schema, aliasing, autograd
  registration, fake implementation against the real one, and the
  operator under AOT dispatch with dynamic shapes), in float32 and
  float64, at B = 1 and 2, at the value and the raised order sets, on a
  grid of the untiled pair and one of the x-tiled pair.
- The fake implementations give the outputs' shapes under a symbolic
  particle count, as a JAX primitive's abstract evaluation does.
- On CPU tensors each operator returns its kernel's plain version, bit for
  bit, and launches nothing.
- Each operator has an implementation for ``cpu`` and ``cuda`` and a fake
  one, and nothing else: no device-agnostic implementation through which a
  CUDA tensor could reach a plain version.

The CUDA implementations launch the hand-written kernels, which run only on
the card: ``chip_smoke.py`` holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch

from cheetah_tpu_torch.ops import cic_common, cic_kernels, cic_tiled
from cheetah_tpu_torch.utils import profiling
from test_torch_cic_plan import RAISED, _bits
from test_torch_cic_tiled import _positions

UNTILED_GRID = (6, 5, 4)
# Past the untiled lead bound (nx * ny = 5200 > 4096): the x-tiled pair.
TILED_GRID = (130, 40, 4)
GRIDS = {"untiled": UNTILED_GRID, "tiled": TILED_GRID}
ORDER_SETS = {"value": cic_kernels.VALUE, "raised": RAISED}
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
OPERATORS = {
    "cic_deposit_multi": cic_kernels.DEPOSIT_MULTI,
    "cic_gather_multi": cic_kernels.GATHER_MULTI,
    "cic_tile_plan": cic_tiled.TILE_PLAN,
    "cic_deposit_tiled": cic_tiled.DEPOSIT_TILED,
    "cic_gather_tiled": cic_tiled.GATHER_TILED,
}


def _finite_positions(rng, batch, num_particles, shape, dtype):
    """Bin-space positions spilling past every edge, some parked at -2: all
    finite, so that opcheck's comparisons of the plan's sorted payload see
    no NaN."""
    normalized = rng.uniform(-1.5, np.asarray(shape) + 0.5, size=(batch, num_particles, 3))
    normalized[:, ::10] = -2.0
    return torch.from_numpy(normalized.astype(dtype))


def _arguments(name, grid, orders, batch, dtype, positions=_finite_positions, seed=0):
    """The operator's arguments for ``grid``, from a numpy seed."""
    np_dtype, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    num_particles, components = 300, 2
    normalized = positions(rng, batch, num_particles, grid, np_dtype)
    flat = list(cic_common.orders_flat(orders))
    if name == "cic_tile_plan":
        return normalized, list(grid)
    plan = tuple(cic_tiled.tile_plan(normalized, grid)[2:])
    if "deposit" in name:
        rows = torch.from_numpy(
            rng.normal(size=(batch, len(orders), components, num_particles)).astype(np_dtype)
        )
        return (normalized, rows, list(grid), flat) + (plan if "tiled" in name else ())
    grids = torch.from_numpy(rng.normal(size=(batch, components, *grid)).astype(np_dtype))
    return (grids, normalized, flat) + (plan if "tiled" in name else ())


_OPCHECK_CASES = [
    (name, grid, orders, batch, dtype)
    for name in OPERATORS
    for grid in GRIDS
    for orders in (("value",) if name == "cic_tile_plan" else ORDER_SETS)
    for batch in (1, 2)
    for dtype in DTYPES
]


@pytest.mark.parametrize(
    "name, grid, orders, batch, dtype", _OPCHECK_CASES,
    ids=["-".join(map(str, case)) for case in _OPCHECK_CASES],
)
def test_opcheck(name, grid, orders, batch, dtype):
    arguments = _arguments(name, GRIDS[grid], ORDER_SETS[orders], batch, dtype)
    results = torch.library.opcheck(OPERATORS[name], arguments)
    assert set(results.values()) == {"SUCCESS"}, results


def _launches() -> list[int]:
    """The CIC kernels' launch counters, by wrapper."""
    counted = profiling.counters()
    return [counted.get(name, 0) for name in (
        "deposit_multi_3d", "gather_multi_3d", "deposit_multi_tiled_3d", "gather_multi_tiled_3d",
        "plan_tiles",
    )]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_operators_are_the_plain_versions_bit_for_bit(grid, dtype):
    """Spilled, parked, NaN and infinite positions; every order set."""
    shape = GRIDS[grid]
    rng = np.random.default_rng(7)
    np_dtype, _ = DTYPES[dtype]
    normalized = torch.from_numpy(_positions(rng, 2, 500, shape, np_dtype))
    rows = torch.from_numpy(rng.normal(size=(2, 3, 2, 500)).astype(np_dtype))
    grids = torch.from_numpy(rng.normal(size=(2, 2, *shape)).astype(np_dtype))
    orders = ((0, 0, 0), (1, 0, 1), (0, 1, 0))
    flat = list(cic_common.orders_flat(orders))
    counts = _launches()

    deposit = cic_kernels.DEPOSIT_MULTI(normalized, rows, list(shape), flat)
    assert torch.equal(
        _bits(deposit), _bits(cic_kernels.deposit_multi_3d_reference(normalized, rows, shape,
                                                                      orders))
    )
    gathered = cic_kernels.GATHER_MULTI(grids, normalized, flat)
    want = cic_kernels.gather_multi_3d_reference(grids, normalized, orders)
    assert gathered.shape == (len(orders), *want[0].shape)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(gathered, want))

    plan = cic_tiled.TILE_PLAN(normalized, list(shape))
    plain_plan = cic_tiled.tile_plan(normalized, shape)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(plan, plain_plan[2:]))
    deposit = cic_tiled.DEPOSIT_TILED(normalized, rows, list(shape), flat, *plan)
    assert deposit.is_contiguous()
    assert torch.equal(_bits(deposit), _bits(cic_tiled.deposit_multi_tiled_3d_reference(
        normalized, rows, shape, orders, plan=plain_plan)))
    gathered = cic_tiled.GATHER_TILED(grids, normalized, flat, *plan)
    want = cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, orders, plan=plain_plan)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(gathered, want))
    assert counts == _launches()
    assert cic_kernels.LIBRARY.handle is None and cic_tiled.LIBRARY.handle is None


class _Call(torch.nn.Module):
    """An operator whose tensor arguments are the module's arguments and
    whose other arguments are fixed."""

    def __init__(self, operator, arguments):
        super().__init__()
        self.operator = operator
        self.fixed = [None if isinstance(a, torch.Tensor) else a for a in arguments]

    def forward(self, *tensors):
        given = iter(tensors)
        return self.operator(*(next(given) if a is None else a for a in self.fixed))


@pytest.mark.parametrize("name", OPERATORS)
def test_fake_shapes_under_a_symbolic_particle_count(name):
    """Exported with the particle axis a ``torch.export.Dim``, each
    operator's outputs carry that axis as the inputs' symbol and every
    other axis at the real outputs' size."""
    grid = GRIDS["untiled" if name in ("cic_deposit_multi", "cic_gather_multi") else "tiled"]
    arguments = _arguments(name, grid, RAISED, 2, "f32")
    tensors = tuple(a for a in arguments if isinstance(a, torch.Tensor))
    n = torch.export.Dim("n")
    # Positions and the plan's (B, N) and (B, N, 3) tensors carry the
    # particles on axis 1, rows (B, O, C, N) on axis 3; grids and offsets
    # have no particle axis.
    dynamic = [
        {3: n} if t.dim() == 4 else {1: n} if t.dim() in (2, 3) and t.shape[1] == 300 else None
        for t in tensors
    ]
    exported = torch.export.export(_Call(OPERATORS[name], arguments), tensors,
                                   dynamic_shapes={"tensors": tuple(dynamic)})
    placeholders = [node for node in exported.graph.nodes if node.op == "placeholder"]
    symbol = str(next(node.meta["val"].shape[1] for node in placeholders
                      if node.meta["val"].dim() in (2, 3) and node.meta["val"].shape[0] == 2
                      and not isinstance(node.meta["val"].shape[1], int)))
    (node,) = [node for node in exported.graph.nodes
               if node.op == "call_function" and name in str(node.target)]
    fakes = node.meta["val"]
    fakes = fakes if isinstance(fakes, (tuple, list)) else (fakes,)
    reals = OPERATORS[name](*arguments)
    reals = reals if isinstance(reals, (tuple, list)) else (reals,)
    assert len(fakes) == len(reals)
    for fake, real in zip(fakes, reals):
        assert fake.dtype == real.dtype and fake.dim() == real.dim()
        for size, wanted in zip(fake.shape, real.shape):
            if wanted == 300:
                assert isinstance(size, torch.SymInt) and str(size) == symbol
            else:
                assert size == wanted


@pytest.mark.parametrize("name", OPERATORS)
def test_implementations_only_for_cpu_and_cuda(name):
    qualname = f"{cic_common.NAMESPACE}::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualname, "CPU") and has(qualname, "CUDA") and has(qualname, "Meta")
    for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd",
                "CompositeExplicitAutogradNonFunctional", "XPU", "MPS", "HIP", "XLA", "Lazy",
                "PrivateUse1", "MTIA"):
        assert not has(qualname, key), key
    backends = {line.split(":")[0] for line in torch._C._dispatch_dump(qualname).splitlines()
                if ": registered at" in line and " :: " in line}
    assert backends == {"CPU", "CUDA", "Meta", "Autograd[alias]"}, backends


def test_a_tensor_on_another_device_raises():
    """A meta tensor reaches the fake implementation; the wrappers refuse
    a device other than the CPU and the card before the dispatcher."""
    normalized = torch.zeros(1, 5, 3, device="meta")
    rows = torch.zeros(1, 1, 1, 5, device="meta")
    out = cic_kernels.DEPOSIT_MULTI(normalized, rows, [4, 4, 4], [0, 0, 0])
    assert out.device.type == "meta" and out.shape == (1, 1, 4, 4, 4)
    with pytest.raises(ValueError, match="Unsupported device"):
        cic_kernels.deposit_multi_3d(normalized, rows, (4, 4, 4), cic_kernels.VALUE)


def test_defining_again_returns_the_operator():
    """A module imported again finds its operators and defines none twice."""
    def refuse(*args):
        raise AssertionError("a second definition ran")

    again = cic_common.define_operator(
        "cic_deposit_multi", "(Tensor a) -> Tensor", refuse, refuse, refuse
    )
    assert again is cic_kernels.DEPOSIT_MULTI


def test_orders_round_trip_through_the_flat_schema_argument():
    for orders in (cic_kernels.VALUE, RAISED, [[1, 1, 1], (0, 0, 1)]):
        flat = cic_common.orders_flat(orders)
        assert len(flat) == 3 * len(orders)
        assert cic_common.orders_from_flat(list(flat)) == cic_common.check_orders(orders)
    with pytest.raises(ValueError, match="3 ints"):
        cic_common.orders_from_flat([0, 0])
    with pytest.raises(ValueError, match="triples"):
        cic_common.orders_from_flat([2, 0, 0])
