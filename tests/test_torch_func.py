"""``torch.func`` transforms through the PyTorch port, against the JAX
package's transforms of the same functions on the CPU.

- ``Segment.length`` of an empty or nested-empty segment is 0.
- Every autograd Function of the port (the singularity-free maths, the CIC
  gather and deposit) under ``torch.func.grad``, ``jvp``, ``jacfwd``,
  ``hessian`` and ``vmap``, against ``jax.grad``, ``jax.jvp``,
  ``jax.jacfwd``, ``jax.hessian`` and ``jax.vmap`` (as
  ``tests/test_maths.py`` and ``tests/test_space_charge.py`` hold the JAX
  package's rules). The CIC Functions run their plain versions here; the
  JAX side binds its primitives with the Pallas kernels in interpret mode.
- The transfer-map builders under ``vmap`` and forward mode, the env step
  ``vmap``-ped over ``k1`` (``tests/test_tracking.py:249-263``), the
  drift-kick-drift quadrupole's Hessian
  (``tests/test_compare_bmadx_dkd.py:165-200``) and
  ``torch.autograd.forward_ad`` through a Quadrupole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as forward_ad
from torch import func

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from cheetah_tpu.ops import transfer_maps as jax_maps
from cheetah_tpu.ops.pallas_cic import cic_deposit_multi_p, cic_gather_multi_p
from cheetah_tpu.utils import maths as jax_maths
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.accelerator.segment import run_transfer_map
from cheetah_tpu_torch.ops import cic_kernels, transfer_maps
from cheetah_tpu_torch.utils import maths
from test_torch_tracking import beam_to_torch, segment_to_torch

F64 = torch.float64
CPU = "cpu"
F32_EPS = float(np.finfo(np.float32).eps)

# ---------------------------------------------------------------------------
# Segment.length
# ---------------------------------------------------------------------------


def test_empty_segment_length_is_zero():
    assert ctt.Segment([]).length.item() == 0.0
    assert ct.Segment([]).length == 0.0


def test_nested_empty_segment_tracks_to_its_length():
    kw = {"dtype": F64, "device": CPU}
    segment = ctt.Segment([ctt.Drift(0.5, **kw), ctt.Segment([])])
    beam = ctt.ParticleBeam(torch.zeros(3, 7, dtype=F64), 1e8)
    assert segment.length.item() == 0.5
    assert segment.track(beam).s.item() == 0.5
    assert ctt.Segment([ctt.Segment([]), ctt.Segment([])]).track(beam).s.item() == 0.0


# ---------------------------------------------------------------------------
# The maths Functions
# ---------------------------------------------------------------------------

# The points avoid |x| < 1e-2, where the closed forms cancel (eps / x^2 in
# the first derivatives, once more in the second: tests/test_torch_grad.py);
# 0 itself is included, where both give the analytic limits.
POINTS = np.array([0.0, 1e-2, -1e-2, 0.3, -0.3, 2.5, -4.0, 30.0, -30.0])
PAIRS = (
    np.array([0.0, 0.0, 0.7, 0.7, -2.0, 0.3, 2.5, -1.5]),
    np.array([0.0, 0.9, 0.0, 0.7, 0.5, -0.7, 2.51, -1.5]),
)
SQRT_PAIRS = (np.array([1.0, 0.9, 1.2, 0.5, 2.0]), np.array([0.0, 0.1, -0.2, 0.3, -0.1]))


def _unary(name):
    points = POINTS[POINTS > -0.9] if name == "log1pdiv" else POINTS
    return getattr(maths, name), getattr(jax_maths, name), (points,)


def _binary(name):
    pairs = SQRT_PAIRS if name == "sqrta2minusbdiva" else PAIRS
    return getattr(maths, name), getattr(jax_maths, name), pairs


def _quartet():
    return (
        lambda x: torch.stack(maths.cos_sinc_sqrt_pm(x)),
        lambda x: jnp.stack(jax_maths.cos_sinc_sqrt_pm(x)),
        (POINTS,),
    )


FUNCTIONS = {
    **{name: (lambda name=name: _unary(name)) for name in (
        "cos_sqrt", "sinc_sqrt", "si1mdiv", "log1pdiv", "sicos1mdiv", "sipsicos3mdiv")},
    **{name: (lambda name=name: _binary(name)) for name in (
        "cossqrtmcosdivdiff", "simsidivdiff", "si2msi2divdiff", "sqrta2minusbdiva")},
    "cos_sinc_sqrt_pm": _quartet,
}
TRANSFORMS = ("grad", "jvp", "jacfwd", "hessian", "vmap")


def _scalar(function):
    """The function summed to a scalar, for grad and hessian."""
    return lambda *xs: function(*xs).sum()


def _transform_torch(kind, function, args):
    argnums = tuple(range(len(args)))
    if kind == "grad":
        return func.grad(_scalar(function), argnums=argnums)(*args)
    if kind == "jvp":
        tangents = tuple(torch.linspace(0.5, 1.5, len(a), dtype=F64) for a in args)
        return func.jvp(function, args, tangents)
    if kind == "jacfwd":
        return func.jacfwd(function, argnums=argnums)(*args)
    if kind == "hessian":
        return func.hessian(_scalar(function), argnums=argnums)(*args)
    # vmap of the gradient at each point: per-example gradients.
    return func.vmap(func.grad(function, argnums=argnums))(*args)


def _transform_jax(kind, function, args):
    argnums = tuple(range(len(args)))
    if kind == "grad":
        return jax.grad(_scalar(function), argnums=argnums)(*args)
    if kind == "jvp":
        tangents = tuple(jnp.linspace(0.5, 1.5, len(a), dtype=jnp.float64) for a in args)
        return jax.jvp(function, args, tangents)
    if kind == "jacfwd":
        return jax.jacfwd(function, argnums=argnums)(*args)
    if kind == "hessian":
        return jax.hessian(_scalar(function), argnums=argnums)(*args)
    return jax.vmap(jax.grad(function, argnums=argnums))(*args)


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_maths_function_transforms_match_jax(name, transform):
    """Values and first derivatives to rtol 1e-9 / atol 1e-11 (eps / x^2 at
    |x| = 1e-2); the Hessian, one more division, to rtol 1e-6 / atol 1e-9,
    as ``tests/test_torch_grad.py`` holds second derivatives."""
    torch_function, jax_function, points = FUNCTIONS[name]()
    if name == "cos_sinc_sqrt_pm" and transform == "vmap":
        torch_function = lambda x: maths.cos_sinc_sqrt_pm(x)[1]  # noqa: E731
        jax_function = lambda x: jax_maths.cos_sinc_sqrt_pm(x)[1]  # noqa: E731
    args_torch = tuple(torch.tensor(p, dtype=F64) for p in points)
    args_jax = tuple(jnp.asarray(p) for p in points)
    got = _transform_torch(transform, torch_function, args_torch)
    want = jax.jit(lambda *a: _transform_jax(transform, jax_function, a))(*args_jax)
    got_leaves = [t.numpy() for t in jax.tree_util.tree_leaves(got)]
    want_leaves = [np.asarray(t) for t in jax.tree_util.tree_leaves(want)]
    assert len(got_leaves) == len(want_leaves)
    rtol, atol = (1e-6, 1e-9) if transform == "hessian" else (1e-9, 1e-11)
    for actual, expected in zip(got_leaves, want_leaves):
        assert actual.shape == expected.shape
        np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol)
        assert np.all(np.isfinite(actual))


def test_maths_forward_ad_matches_jvp():
    x = torch.tensor(POINTS, dtype=F64)
    tangent = torch.linspace(-1.0, 1.0, len(POINTS), dtype=F64)
    for function in (maths.cos_sqrt, maths.sinc_sqrt, maths.si1mdiv, maths.sicos1mdiv):
        with forward_ad.dual_level():
            dual = function(forward_ad.make_dual(x, tangent))
            got = forward_ad.unpack_dual(dual).tangent
        _, expected = func.jvp(function, (x,), (tangent,))
        assert torch.equal(got, expected)


# ---------------------------------------------------------------------------
# The CIC Functions
# ---------------------------------------------------------------------------

ORDERS = ((0, 0, 0), (1, 0, 0), (0, 1, 1))
UNTILED, TILED = (8, 7, 6), (160, 40, 16)


def _cic_case(seed, shape, batch=2, components=2, num_particles=300, orders=ORDERS):
    """float32 positions (some parked off the grid), grids, rows and
    tangents, made with numpy."""
    rng = np.random.default_rng(seed)
    normalized = rng.uniform(-1.5, np.asarray(shape) + 0.5, size=(batch, num_particles, 3))
    normalized[:, ::10] = -2.0
    arrays = {
        "normalized": normalized,
        "grids": rng.normal(size=(batch, components, *shape)),
        "rows": rng.normal(size=(batch, len(orders), components, num_particles)),
        "normalized_dot": rng.normal(size=(batch, num_particles, 3)),
        "grids_dot": rng.normal(size=(batch, components, *shape)),
        "rows_dot": rng.normal(size=(batch, len(orders), components, num_particles)),
    }
    return {key: value.astype(np.float32) for key, value in arrays.items()}


def _t(case, *keys):
    return tuple(torch.from_numpy(case[key]) for key in keys)


def _j(case, *keys):
    return tuple(jnp.asarray(case[key]) for key in keys)


def _tolerance(expected, terms):
    """K * eps * max|expected| for K float32 terms summed per output."""
    return terms * F32_EPS * max(float(np.abs(np.asarray(expected)).max()), 1.0)


@pytest.mark.parametrize("shape", [UNTILED, TILED], ids=["untiled", "tiled"])
def test_gather_jvp_matches_jax(shape):
    """Tangents in grids and positions (``tests/test_space_charge.py:521``)."""
    case = _cic_case(51, shape)

    def gather(g, n):
        return torch.stack(cic_kernels.differentiable_gather(g, n, ORDERS))

    def jax_gather(g, n):
        return jnp.stack(cic_gather_multi_p.bind(g, n, orders=ORDERS, interpret=True))

    value, tangent = func.jvp(gather, _t(case, "grids", "normalized"),
                              _t(case, "grids_dot", "normalized_dot"))
    want_value, want_tangent = jax.jvp(jax_gather, _j(case, "grids", "normalized"),
                                       _j(case, "grids_dot", "normalized_dot"))
    # 8 corners of raised weights times a tangent per output.
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=0,
                               atol=_tolerance(want_value, 8))
    np.testing.assert_allclose(tangent.numpy(), np.asarray(want_tangent), rtol=0,
                               atol=_tolerance(want_tangent, 32))


@pytest.mark.parametrize("shape", [UNTILED, TILED], ids=["untiled", "tiled"])
def test_deposit_jvp_matches_jax(shape):
    """Tangents in positions and rows: one summed deposit."""
    case = _cic_case(52, shape)

    def deposit(n, r):
        return cic_kernels.differentiable_deposit(n, r, shape, ORDERS)

    def jax_deposit(n, r):
        return cic_deposit_multi_p.bind(n, r, histogram_shape=shape, orders=ORDERS,
                                        interpret=True)

    value, tangent = func.jvp(deposit, _t(case, "normalized", "rows"),
                              _t(case, "normalized_dot", "rows_dot"))
    want_value, want_tangent = jax.jvp(jax_deposit, _j(case, "normalized", "rows"),
                                       _j(case, "normalized_dot", "rows_dot"))
    # A cell sums 8 corners x 3 orders x a few particles of each batch.
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=0,
                               atol=_tolerance(want_value, 96))
    np.testing.assert_allclose(tangent.numpy(), np.asarray(want_tangent), rtol=0,
                               atol=_tolerance(want_tangent, 192))


@pytest.mark.parametrize("shape", [UNTILED, TILED], ids=["untiled", "tiled"])
def test_gather_and_deposit_vmap_match_jax(shape):
    """An outer vmap folds into the leading batch axis; an unmapped grid is
    repeated for every instance (``tests/test_space_charge.py:579``)."""
    case = _cic_case(53, shape, batch=3)
    grids, normalized, rows = _t(case, "grids", "normalized", "rows")

    got = func.vmap(lambda n: torch.stack(cic_kernels.differentiable_gather(
        grids[:1], n[None], ORDERS)))(normalized)
    want = jax.vmap(lambda n: jnp.stack(cic_gather_multi_p.bind(
        jnp.asarray(case["grids"][:1]), n[None], orders=ORDERS, interpret=True)))(
        jnp.asarray(case["normalized"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tolerance(want, 8))

    got = func.vmap(lambda n, r: cic_kernels.differentiable_deposit(
        n[None], r[None], shape, ORDERS))(normalized, rows)
    want = jax.vmap(lambda n, r: cic_deposit_multi_p.bind(
        n[None], r[None], histogram_shape=shape, orders=ORDERS, interpret=True))(
        *_j(case, "normalized", "rows"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tolerance(want, 96))
    # vmap of the gradient with respect to the positions.
    got = func.vmap(func.grad(lambda n, r: (cic_kernels.differentiable_deposit(
        n[None], r[None], shape, ORDERS) ** 2).sum()))(normalized, rows)
    want = jax.vmap(jax.grad(lambda n, r: jnp.sum(cic_deposit_multi_p.bind(
        n[None], r[None], histogram_shape=shape, orders=ORDERS, interpret=True) ** 2)))(
        *_j(case, "normalized", "rows"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_tolerance(want, 512))


def _pipelines(shape=(6, 6, 6), num_particles=40):
    """A deposit -> gather -> nonlinear readout scalar loss of the positions,
    in both packages (``tests/test_space_charge.py:631-661``)."""
    rng = np.random.default_rng(81)
    positions = rng.uniform(0.2, np.asarray(shape) - 1.2, size=(1, num_particles, 3))
    charges = rng.uniform(size=(1, 1, 1, num_particles))
    positions, charges = positions.astype(np.float32), charges.astype(np.float32)

    def loss_torch(p):
        grid = cic_kernels.differentiable_deposit(p, torch.from_numpy(charges), shape)
        (values,) = cic_kernels.differentiable_gather(grid, p)
        return torch.sum(torch.sin(values * 3.0) * values)

    def loss_jax(p):
        grid = cic_deposit_multi_p.bind(p, jnp.asarray(charges), histogram_shape=shape,
                                        orders=((0, 0, 0),), interpret=True)
        (values,) = cic_gather_multi_p.bind(grid, p, orders=((0, 0, 0),), interpret=True)
        return jnp.sum(jnp.sin(values * 3.0) * values)

    v = rng.normal(size=positions.shape).astype(np.float32)
    return loss_torch, loss_jax, positions, v


def test_cic_hessian_vector_products_match_jax():
    """Forward-over-reverse and reverse-over-reverse HVPs and the third-order
    contraction (``tests/test_space_charge.py:664-704``): the rules call the
    Functions again at raised orders. float32 on both sides, through
    a sin readout that amplifies rounding: rtol 2e-3, atol 1e-4 of the
    largest entry, as the JAX package's own test."""
    loss_torch, loss_jax, positions, v = _pipelines()
    p, vt = torch.from_numpy(positions), torch.from_numpy(v)
    want = jax.jvp(jax.grad(loss_jax), (jnp.asarray(positions),), (jnp.asarray(v),))[1]
    fwd_rev = func.jvp(func.grad(loss_torch), (p,), (vt,))[1]
    rev_rev = func.grad(lambda q: torch.sum(func.grad(loss_torch)(q) * vt))(p)
    scale = float(np.abs(np.asarray(want)).max())
    for got in (fwd_rev, rev_rev):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=1e-4 * scale)

    def third(grad, jvp, loss, p, v, vdot):
        return grad(lambda q: vdot(jvp(grad(loss), (q,), (v,))[1], v))(p)

    got = third(func.grad, func.jvp, loss_torch, p, vt, lambda a, b: torch.sum(a * b))
    want = third(jax.grad, jax.jvp, loss_jax, jnp.asarray(positions), jnp.asarray(v), jnp.vdot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=5e-3 * float(np.abs(np.asarray(want)).max()))


def test_cic_hessian_and_jacfwd_of_grad_match_jax():
    """``hessian`` and ``jacfwd(grad)`` of the pipeline with respect to a
    scale of the positions (``tests/test_space_charge.py:736-785``)."""
    loss_torch, loss_jax, positions, _ = _pipelines()
    p = torch.from_numpy(positions)

    def scaled_torch(s):
        return loss_torch(p * s)

    def scaled_jax(s):
        return loss_jax(jnp.asarray(positions) * s)

    s_torch, s_jax = torch.tensor(1.05), jnp.asarray(1.05, jnp.float32)
    want = float(jax.hessian(scaled_jax)(s_jax))
    for got in (func.hessian(scaled_torch)(s_torch), func.jacfwd(func.grad(scaled_torch))(s_torch)):
        assert np.isfinite(got.item())
        assert got.item() == pytest.approx(want, rel=1e-2)


def test_cic_rules_stay_on_the_functions(monkeypatch):
    """Every rule of a transform goes through GatherMulti or DepositMulti,
    whose forward is the wrapper that launches the kernel on a card: count
    the wrapper calls of a jvp and of a vmap."""
    calls = {"gather": 0, "deposit": 0}
    gather, deposit = cic_kernels.gather_multi_3d, cic_kernels.deposit_multi_3d

    def counted_gather(*args, **kwargs):
        calls["gather"] += 1
        return gather(*args, **kwargs)

    def counted_deposit(*args, **kwargs):
        calls["deposit"] += 1
        return deposit(*args, **kwargs)

    monkeypatch.setattr(cic_kernels, "gather_multi_3d", counted_gather)
    monkeypatch.setattr(cic_kernels, "deposit_multi_3d", counted_deposit)
    case = _cic_case(54, UNTILED)
    grids, normalized, rows, n_dot, r_dot = _t(
        case, "grids", "normalized", "rows", "normalized_dot", "rows_dot")
    func.jvp(lambda n: cic_kernels.differentiable_gather(grids, n, ORDERS)[0],
             (normalized,), (n_dot,))
    # The primal at its orders, one gather at the deduplicated raised orders.
    assert calls == {"gather": 2, "deposit": 0}
    func.jvp(lambda n, r: cic_kernels.differentiable_deposit(n, r, UNTILED, ORDERS),
             (normalized, rows), (n_dot, r_dot))
    # The primal and one summed tangent deposit.
    assert calls == {"gather": 2, "deposit": 2}
    func.vmap(lambda n: cic_kernels.differentiable_gather(grids, n, ORDERS)[0])(
        torch.stack([normalized, normalized.flip(1)]))
    assert calls == {"gather": 3, "deposit": 2}


# ---------------------------------------------------------------------------
# Transfer maps, the env step and the elements
# ---------------------------------------------------------------------------


def test_map_builders_under_vmap_and_jvp_match_jax():
    species = ctt.Species("electron", dtype=F64, device=CPU)
    jax_species = ct.Species("electron")
    lengths = np.array([0.1, 0.3, 0.7])
    k1 = np.array([-6.0, 0.0, 9.0])
    energy = np.asarray(1.54e8)

    got = func.vmap(lambda l: transfer_maps.drift_matrix(l, torch.tensor(energy), species))(
        torch.tensor(lengths))
    want = jax.vmap(lambda l: jax_maps.drift_matrix(l, jnp.asarray(energy), jax_species))(
        jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)

    def rmatrix_torch(k):
        return transfer_maps.base_rmatrix(torch.tensor(0.2, dtype=F64), k,
                                          torch.tensor(0.0, dtype=F64), species,
                                          torch.tensor(energy))

    def rmatrix_jax(k):
        return jax_maps.base_rmatrix(jnp.asarray(0.2), k, jnp.asarray(0.0), jax_species,
                                     jnp.asarray(energy))

    got = func.vmap(rmatrix_torch)(torch.tensor(k1))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.vmap(rmatrix_jax)(jnp.asarray(k1))),
                               rtol=1e-13, atol=1e-15)
    for k in k1:
        _, tangent = func.jvp(rmatrix_torch, (torch.tensor(k),), (torch.tensor(1.0, dtype=F64),))
        _, want = jax.jvp(rmatrix_jax, (jnp.asarray(k),), (jnp.asarray(1.0),))
        np.testing.assert_allclose(tangent.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def _buffer_name(segment, tensor) -> str:
    return next(name for name, buffer in segment.named_buffers() if buffer is tensor)


def test_env_step_vmap_over_k1_matches_batched_k1():
    """``torch.func.vmap`` of the env step over AREAMQZM1's k1 (through
    ``torch.func.functional_call``) equals tracking the vector of k1 at
    once, and ``jax.vmap`` of the JAX package (rtol 1e-12)."""
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64)
    beam = ct.ParticleBeam.from_parameters(
        num_particles=100, energy=jnp.asarray(1.5e8, jnp.float64), key=jax.random.PRNGKey(3),
        dtype=jnp.float64,
    )
    k1 = np.linspace(-5.0, 5.0, 8)
    segment, port_beam = segment_to_torch(jax_segment), beam_to_torch(beam)
    name = _buffer_name(segment, segment.AREAMQZM1.k1)

    def track_k1(k):
        return func.functional_call(segment, {name: k}, (port_beam,)).mu_x

    got = func.vmap(track_k1)(torch.tensor(k1))
    segment.AREAMQZM1.k1 = torch.tensor(k1)
    batched = segment.track(port_beam).mu_x
    np.testing.assert_allclose(got.numpy(), batched.numpy(), rtol=1e-12, atol=1e-18)

    def jax_track_k1(k, s, b):
        s.AREAMQZM1.k1 = k
        return s.track(b).mu_x

    want = jax.vmap(jax_track_k1, in_axes=(0, None, None))(jnp.asarray(k1), jax_segment, beam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-18)


def _dkd_beam():
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    return ct.ParticleBeam.from_twiss(
        num_particles=1_000, beta_x=a(5.0), emittance_x=a(2e-9), beta_y=a(3.0),
        emittance_y=a(2e-9), energy=a(1.54e8), sigma_p=a(1e-3), key=jax.random.PRNGKey(5),
        dtype=jnp.float64,
    )


def test_dkd_quadrupole_hessian_matches_jax_and_finite_difference():
    """``torch.func.hessian`` of sigma_x through the drift-kick-drift
    quadrupole (the quartet's and the series' rules, twice), finite at k1 = 0,
    equal to ``jax.hessian`` (rtol 1e-8) and to a central difference of the
    gradient (rtol 1e-6, as the JAX package's test)."""
    beam = _dkd_beam()
    port_beam = beam_to_torch(beam)

    def loss(k1):
        quad = ctt.Quadrupole(0.3, tracking_method="drift_kick_drift", dtype=F64, device=CPU)
        return func.functional_call(quad, {"k1": k1}, (port_beam,)).sigma_x

    def jax_loss(k1):
        quad = ct.Quadrupole(length=jnp.asarray(0.3, jnp.float64), k1=k1,
                             tracking_method="drift_kick_drift")
        return quad.track(beam).sigma_x

    k1 = torch.tensor(8.0, dtype=F64)
    hessian = func.hessian(loss)(k1)
    assert hessian.item() == pytest.approx(float(jax.hessian(jax_loss)(jnp.asarray(8.0))),
                                           rel=1e-8)
    eps = 1e-4
    fd = (func.grad(loss)(k1 + eps) - func.grad(loss)(k1 - eps)) / (2 * eps)
    assert hessian.item() == pytest.approx(fd.item(), rel=1e-6)
    assert np.isfinite(func.hessian(loss)(torch.tensor(0.0, dtype=F64)).item())


@pytest.mark.parametrize("method", ["linear", "drift_kick_drift"])
def test_forward_ad_through_quadrupole_matches_jax(method):
    """``torch.autograd.forward_ad`` through one Quadrupole: the tangent of
    sigma_x along k1 equals ``torch.func.jvp`` and ``jax.jvp`` (rtol 1e-10)."""
    beam = _dkd_beam()
    port_beam = beam_to_torch(beam)
    quad = ctt.Quadrupole(0.3, k1=8.0, misalignment=(1e-4, -2e-4), tilt=0.05,
                          tracking_method=method, dtype=F64, device=CPU)
    k1 = torch.tensor(8.0, dtype=F64)
    one = torch.tensor(1.0, dtype=F64)
    with forward_ad.dual_level():
        quad.k1 = forward_ad.make_dual(k1, one)
        got = forward_ad.unpack_dual(quad.track(port_beam).sigma_x).tangent
    quad.k1 = k1
    _, via_jvp = func.jvp(
        lambda k: func.functional_call(quad, {"k1": k}, (port_beam,)).sigma_x, (k1,), (one,))

    def jax_sigma(k):
        return ct.Quadrupole(
            length=jnp.asarray(0.3, jnp.float64), k1=k,
            misalignment=jnp.asarray([1e-4, -2e-4], jnp.float64),
            tilt=jnp.asarray(0.05, jnp.float64), tracking_method=method,
        ).track(beam).sigma_x

    _, want = jax.jvp(jax_sigma, (jnp.asarray(8.0),), (jnp.asarray(1.0),))
    assert got.item() == pytest.approx(via_jvp.item(), rel=1e-12)
    assert got.item() == pytest.approx(float(want), rel=1e-10)


def test_vmap_and_grad_over_cavity_voltage_match_jax():
    """``torch.func.vmap`` and ``grad`` of config 3's sigma_x over the
    cavity's voltage, 0 included: a transform's argument is never read on
    the host, so the cavity is never fused away as off (the JAX package
    decides so for traced values). Against ``jax.vmap`` and ``jax.grad``,
    rtol 1e-9 (the chain's closed forms over 500 particles)."""
    from test_torch_nonlinear import _beam_arrays, _chain, _jax_beam

    jax_segment = _chain()
    beam = _jax_beam(*_beam_arrays(num_particles=500, seed=9))
    segment, port_beam = segment_to_torch(jax_segment), beam_to_torch(beam)
    name = _buffer_name(segment, segment.cav.voltage)
    voltages = np.array([0.0, 1e7, 2e7])

    def sigma_x(v):
        return func.functional_call(segment, {name: v}, (port_beam,)).sigma_x

    def jax_sigma_x(v, s):
        s.cav.voltage = v
        return s.track(beam).sigma_x

    got = func.vmap(sigma_x)(torch.tensor(voltages))
    want = jax.jit(jax.vmap(jax_sigma_x, in_axes=(0, None)))(jnp.asarray(voltages), jax_segment)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    for voltage in (0.0, 2e7):
        grad = func.grad(sigma_x)(torch.tensor(voltage, dtype=F64))
        expected = jax.jit(jax.grad(jax_sigma_x))(jnp.asarray(voltage), jax_segment)
        assert grad.item() == pytest.approx(float(expected), rel=1e-9)
    assert segment.cav.is_skippable is False


def test_constants_made_inside_a_transform_are_not_cached():
    """The map builders' cached constants (``utils.device.constant_cache``)
    are built anew inside a ``torch.func`` transform: a tensor made there is
    the transform's wrapper, whose storage is gone once it ends, so caching
    it broke later compiled maps of the same shape ("Cannot access storage
    of TensorWrapper")."""
    quadrupole = ctt.Quadrupole(0.2, k1=3.0, dtype=F64, device=CPU)
    energy = torch.tensor(1e8, dtype=F64)
    species = ctt.Species("electron", dtype=F64, device=CPU)
    # A vector shape no other test builds, so the first build of its
    # constants happens inside the transform.
    k1 = torch.linspace(-4.0, 4.0, 5, dtype=F64).reshape(5, 1, 1, 1)

    def trace(k1):
        quadrupole.k1 = k1
        return quadrupole.first_order_transfer_map(energy, species)[..., 0, 0].sum()

    grad = func.grad(trace)(k1)
    quadrupole.k1 = k1
    # A compiled program runs the fused-map operator's plain version, which
    # cannot read a dead wrapper's storage.
    torch._dynamo.reset()
    try:
        compiled = torch.compile(lambda q, e: run_transfer_map([q], e, species),
                                 backend="aot_eager", fullgraph=True)
        fused = compiled(quadrupole, energy)
    finally:
        torch._dynamo.reset()
    eager = quadrupole.first_order_transfer_map(energy, species)
    assert fused.shape == eager.shape == (5, 1, 1, 1, 7, 7) and grad.shape == k1.shape
    assert torch.equal(fused, eager) and torch.isfinite(grad).all()
