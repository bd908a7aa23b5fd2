"""The diagnostics of the PyTorch port against cheetah_tpu: the 1D and 2D
cloud-in-cell deposit, the KDE histograms, ``Screen`` (histogram,
cloud-in-cell, KDE with its window and fallback, the ``ParameterBeam`` pdf),
``BPM``, ``Aperture`` and ``Segment.track_with_readings``.

Inputs are made with numpy (or by the JAX package) and cross over as numpy
arrays; everything runs in float64. Tolerances: the deposits, the pdf and
the KDE images agree to rel 1e-10 of the image's largest pixel (sums in a
different order); histograms agree exactly where the pixel edges are equal,
which ``test_pixel_edges_equal_jax`` holds bit for bit.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parameter_beam import jit_call, numpy_beam, parameter_beam_to_torch
from test_torch_tracking import beam_to_torch, segment_to_torch

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from cheetah_tpu.ops.cloud_in_cell import cloud_in_cell_charge_deposition as jax_cic
from cheetah_tpu.utils.kde import kde_histogram_1d as jax_kde_1d
from cheetah_tpu.utils.kde import kde_histogram_2d as jax_kde_2d
from cheetah_tpu.utils.warnings import PhysicsWarning as JaxPhysicsWarning
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.lattices import ares_ea_subcell
from cheetah_tpu_torch.ops.cloud_in_cell import cloud_in_cell_charge_deposition
from cheetah_tpu_torch.utils import kde
from cheetah_tpu_torch.utils.warnings import PhysicsWarning

CPU = "cpu"
F64 = torch.float64
RTOL = 1e-10
METHODS = ["histogram", "kde", "cloud-in-cell"]


def assert_image_close(actual, expected, rtol=RTOL, err_msg=""):
    """Images agree to ``rtol`` of their largest pixel."""
    expected = np.asarray(expected)
    actual = actual.detach().numpy()
    assert actual.shape == expected.shape, err_msg
    np.testing.assert_allclose(
        actual, expected, rtol=rtol, atol=rtol * np.abs(expected).max(), err_msg=err_msg
    )


@functools.lru_cache
def _jax_beam(num_particles=2000, mu_x=1e-4, seed=0):
    return numpy_beam(num_particles, seed, (3e-4, 4e-6, 2e-4, 4e-6, 8e-6, 2e-3),
                      mu=(mu_x, 0.0, 0.0, 0.0, 0.0, 0.0), correlation=0.0)


def _jax_screen(**kwargs):
    spec = dict(resolution=(64, 48), pixel_size=jnp.asarray([4e-5, 3e-5], jnp.float64),
                is_active=True, name="scr")
    spec.update(kwargs)
    return ct.Screen(**spec)


def _screen_to_torch(jax_screen):
    return segment_to_torch(ct.Segment([jax_screen])).elements[0]


# ----------------------------------------------------------------------------
# The 1D and 2D deposit
# ----------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bins, batch",
    [((12,), ()), ((8, 10), ()), ((8, 10), (3,)), ((300, 260), ())],
    ids=["1d", "2d", "2d_batched", "2d_past_tensor_product"],
)
def test_cloud_in_cell_deposit_matches(bins, batch):
    """The JAX package takes its tensor-product deposit for small grids and
    the scatter for the last case (more than 65536 cells); both are the
    port's one scatter."""
    rng = np.random.default_rng(11)
    ndim = len(bins)
    positions = rng.normal(size=(*batch, 1000, ndim))
    positions[..., :7, 0] = [-2.5, 2.5, 2.6, -3.0, np.inf, 2.4999, 0.0]
    charges = rng.uniform(size=(*batch, 1000))
    extent = np.stack([np.full(ndim, -2.5), np.full(ndim, 2.5)], axis=-1)
    expected = jax_cic(jnp.asarray(positions), bins, jnp.asarray(extent), jnp.asarray(charges))
    actual = cloud_in_cell_charge_deposition(
        torch.from_numpy(positions), bins, torch.from_numpy(extent), torch.from_numpy(charges)
    )
    finite = np.isfinite(np.asarray(expected))
    assert actual.shape == expected.shape == (*batch, *bins)
    np.testing.assert_array_equal(np.isfinite(actual.numpy()), finite)
    np.testing.assert_allclose(actual.numpy()[finite], np.asarray(expected)[finite],
                               rtol=RTOL, atol=RTOL * np.nanmax(np.asarray(expected)))


def test_cloud_in_cell_default_extent_and_charges():
    rng = np.random.default_rng(12)
    positions = rng.normal(size=(3, 500, 2))
    expected = jax_cic(jnp.asarray(positions), (16, 16))
    actual = cloud_in_cell_charge_deposition(torch.from_numpy(positions), 16)
    assert_image_close(actual, expected)


def test_cloud_in_cell_gradients():
    """gradcheck of the 2D deposit in float64 (positions off the cell
    centres, where the weights have kinks), and its gradient against
    jax.grad."""
    rng = np.random.default_rng(13)
    positions = rng.uniform(-2.9, 2.9, size=(40, 2))
    centres = (np.round((positions + 3.0) / 0.75 - 0.5) + 0.5) * 0.75 - 3.0
    positions += 0.1 * (np.abs(positions - centres) < 0.05)
    charges = rng.uniform(size=40)
    extent = np.array([[-3.0, 3.0], [-3.0, 3.0]])
    weights = rng.normal(size=(8, 8))

    def loss(p, q):
        grid = cloud_in_cell_charge_deposition(p, (8, 8), torch.from_numpy(extent), q)
        return torch.sum(grid * torch.from_numpy(weights))

    p = torch.tensor(positions, requires_grad=True)
    q = torch.tensor(charges, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda p, q: cloud_in_cell_charge_deposition(p, (8, 8), torch.from_numpy(extent), q),
        (p, q),
    )
    grad_p, grad_q = torch.autograd.grad(loss(p, q), (p, q))
    expected_p, expected_q = jax.grad(
        lambda p, q: jnp.sum(jax_cic(p, (8, 8), jnp.asarray(extent), q) * weights), (0, 1)
    )(jnp.asarray(positions), jnp.asarray(charges))
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(expected_p), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(grad_q.numpy(), np.asarray(expected_q), rtol=RTOL, atol=1e-12)


# ----------------------------------------------------------------------------
# KDE
# ----------------------------------------------------------------------------


def test_kde_histograms_match():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 5000)) * 1e-4
    y = rng.normal(size=(2, 5000)) * 8e-5
    w = rng.uniform(size=(2, 5000))
    bins1, bins2 = np.linspace(-4e-4, 4e-4, 50), np.linspace(-3e-4, 3e-4, 40)
    bandwidth = 2e-5
    expected = jax_kde_2d(*(jnp.asarray(a) for a in (x, y, bins1, bins2, bandwidth, w)))
    actual = kde.kde_histogram_2d(
        *(torch.tensor(a, dtype=F64) for a in (x, y, bins1, bins2, bandwidth, w))
    )
    assert_image_close(actual, expected)
    assert_image_close(
        kde.kde_histogram_1d(*(torch.tensor(a, dtype=F64) for a in (x, bins1, bandwidth))),
        jax_kde_1d(jnp.asarray(x), jnp.asarray(bins1), jnp.asarray(bandwidth)),
    )


@pytest.mark.parametrize("wide", [False, True], ids=["window", "fallback"])
def test_kde_window_and_fallback(wide):
    """A 2448 x 2040 grid: a narrow beam takes the 512-bin window, a wide
    one falls back to the full evaluation; both agree with the JAX package's
    (which makes the same choice) and with the full evaluation."""
    rng = np.random.default_rng(15)
    n = 1000
    if wide:
        x, y = rng.uniform(-3.5e-3, 3.5e-3, n), rng.uniform(-2.5e-3, 2.5e-3, n)
    else:
        x, y = rng.normal(size=n) * 1e-4 + 3e-4, rng.normal(size=n) * 8e-5 - 2e-4
    w = rng.uniform(size=n)
    bins1 = np.asarray(jnp.linspace(-4e-3, 4e-3, 2448))
    bins2 = np.asarray(jnp.linspace(-3e-3, 3e-3, 2040))
    args = [x, y, bins1, bins2, 5e-6, w]
    expected = jax_kde_2d(*(jnp.asarray(a) for a in args), window=512)
    torch_args = [torch.tensor(a, dtype=F64) for a in args]
    _, _, fits = kde.window_placement(*torch_args[:5], 512)
    assert fits is not wide
    windowed = kde.kde_histogram_2d(*torch_args, window=512)
    assert_image_close(windowed, expected)
    assert_image_close(windowed, kde.kde_histogram_2d(*torch_args), rtol=1e-9)


def test_kde_bins_uniform_in_float32():
    """float32 pixel centres are uniform to their rounding, so the port's
    window serves float32 screens too (the JAX package's rtol 1e-9 test
    rejects them)."""
    screen = ctt.Screen(resolution=(2448, 2040), pixel_size=(3.3198e-6, 2.4469e-6),
                        dtype=torch.float32, device=CPU)
    centers_x, centers_y = screen.pixel_bin_centers
    assert kde.bins_uniform(centers_x) and kde.bins_uniform(centers_y)
    assert not kde.bins_uniform(torch.cat([centers_x[:100], centers_x[101:]]))


# ----------------------------------------------------------------------------
# Screen
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("binning", [1, 8])
def test_pixel_edges_equal_jax(dtype, binning):
    """The edges that decide a histogram's pixels (the first two and the
    last) equal the JAX package's bit for bit; every edge and centre is
    within one rounding of it (XLA contracts ``jnp.linspace`` into fused
    multiply-adds in its vector loop but not in the loop's remainder, which
    at binning 1 is empty: there all of them are equal in float64)."""
    jax_dtype = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    jax_screen = jax_ares_ea_subcell(dtype=jax_dtype, screen=True).AREABSCR1
    jax_screen.binning = binning
    screen = ares_ea_subcell(dtype, device=CPU, screen=True).AREABSCR1
    screen.binning = binning
    eps = torch.finfo(dtype).eps
    np.testing.assert_array_equal(screen.extent.numpy(), np.asarray(jax_screen.extent))
    for got, want in zip(screen.pixel_bin_edges + screen.pixel_bin_centers,
                         jax_screen.pixel_bin_edges + jax_screen.pixel_bin_centers):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=eps * np.abs(want).max())
    for got, want in zip(screen.pixel_bin_edges, jax_screen.pixel_bin_edges):
        np.testing.assert_array_equal(got.numpy()[[0, 1, -1]], np.asarray(want)[[0, 1, -1]])


@pytest.mark.parametrize("method", METHODS)
def test_screen_reading_matches(method):
    jax_beam = _jax_beam()
    jax_screen = _jax_screen(method=method, misalignment=jnp.asarray([1e-5, -2e-5]))
    screen = _screen_to_torch(jax_screen)
    assert torch.equal(screen.reading, torch.zeros(48, 64, dtype=F64))
    screen.track(beam_to_torch(jax_beam))
    expected = jit_call(lambda s, b: s.observe(b), jax_screen, jax_beam)
    assert_image_close(screen.reading, expected, err_msg=method)
    assert screen.reading.shape == (48, 64)


@pytest.mark.parametrize("method", METHODS)
def test_ares_screen_binning_8(method):
    """The AREABSCR1 screen at binning 8 (306 x 255 pixels) at the end of
    the ARES EA subcell."""
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64, screen=True)
    jax_segment.AREABSCR1.method = method
    jax_segment.AREABSCR1.binning = 8
    segment = ares_ea_subcell(F64, device=CPU, screen=True)
    segment.AREABSCR1.method = method
    segment.AREABSCR1.binning = 8
    jax_beam = _jax_beam(num_particles=2000, mu_x=0.0, seed=1)
    _, expected = jit_call(lambda s, b: s.track_with_readings(b), jax_segment, jax_beam)
    _, readings = segment.track_with_readings(beam_to_torch(jax_beam))
    assert readings["AREABSCR1"].shape == (255, 306)
    assert_image_close(readings["AREABSCR1"], expected["AREABSCR1"], err_msg=method)


@pytest.mark.parametrize("wide", [False, True], ids=["window", "fallback"])
def test_ares_screen_kde_full_resolution(wide):
    jax_screen = jax_ares_ea_subcell(dtype=jnp.float64, screen=True).AREABSCR1
    jax_screen.method = "kde"
    screen = ares_ea_subcell(F64, device=CPU, screen=True).AREABSCR1
    screen.method = "kde"
    jax_beam = _jax_beam(num_particles=1000, mu_x=0.0, seed=2)
    # A beam of sigma 60 x 40 um fits the 512-pixel window with its margin;
    # one spread over 6 mm does not.
    particles = jax_beam.particles.at[:, :4].multiply(0.2)
    if wide:
        particles = particles.at[:, 0].set(np.linspace(-3e-3, 3e-3, 1000))
    jax_beam = ct.ParticleBeam(particles, jax_beam.energy,
                               particle_charges=jax_beam.particle_charges)
    beam = beam_to_torch(jax_beam)
    _, _, fits = kde.window_placement(beam.x, beam.y, *screen.pixel_bin_centers,
                                      screen.kde_bandwidth, 512)
    assert fits is not wide
    assert_image_close(screen.observe(beam),
                       jit_call(lambda s, b: s.observe(b), jax_screen, jax_beam))


def test_parameter_beam_image():
    jax_beam = ct.ParameterBeam.from_parameters(
        mu_x=jnp.asarray([0.0, 2e-4]), sigma_x=jnp.asarray(3e-4), sigma_y=jnp.asarray(2e-4),
        cov_xy=jnp.asarray(2e-8), energy=jnp.asarray(1.5e8), dtype=jnp.float64,
    )
    jax_screen = _jax_screen(resolution=(32, 24), pixel_size=jnp.asarray([1e-4, 1e-4]),
                             misalignment=jnp.asarray([3e-5, 0.0]))
    image = _screen_to_torch(jax_screen).observe(parameter_beam_to_torch(jax_beam))
    assert image.shape == (2, 24, 32)
    assert_image_close(image, jit_call(lambda s, b: s.observe(b), jax_screen, jax_beam))


@pytest.mark.parametrize("method", METHODS)
def test_misaligned_vectorised_screen(method):
    """A misalignment of shape (3, 1, 2) against a beam of 2 instances
    gives (3, 2) images, as in the JAX package."""
    jax_base = _jax_beam(num_particles=1500)
    particles = jnp.stack([jax_base.particles, jax_base.particles.at[:, 0].add(1e-4)])
    jax_beam = ct.ParticleBeam(particles, jax_base.energy,
                               particle_charges=jax_base.particle_charges)
    misalignment = jnp.asarray([[[1e-5, -2e-5]], [[0.0, 0.0]], [[-3e-5, 4e-5]]])
    jax_screen = _jax_screen(method=method, resolution=(32, 24),
                             pixel_size=jnp.asarray([8e-5, 6e-5]), misalignment=misalignment)
    image = _screen_to_torch(jax_screen).observe(beam_to_torch(jax_beam))
    assert image.shape == (3, 2, 24, 32)
    assert_image_close(image, jit_call(lambda s, b: s.observe(b), jax_screen, jax_beam),
                       err_msg=method)


@pytest.mark.parametrize("kind", ["particle", "parameter"])
def test_blocking_screen(kind):
    jax_beam = _jax_beam()
    beam = beam_to_torch(jax_beam)
    if kind == "parameter":
        beam = beam.as_parameter_beam()
    screen = ctt.Screen(is_active=True, is_blocking=True, dtype=F64, device=CPU)
    out = screen.track(beam)
    assert out.total_charge.item() == 0.0 and beam.total_charge.item() > 0
    assert ctt.Screen(is_blocking=True, dtype=F64, device=CPU).track(beam) is beam


def test_screen_reading_cache_and_dtype():
    beam = beam_to_torch(_jax_beam()).to(dtype=torch.float32)
    screen = ctt.Screen(resolution=(40, 30), pixel_size=(5e-5, 5e-5), is_active=True,
                        dtype=torch.float32, device=CPU)
    screen.track(beam)
    first = screen.reading
    assert first.dtype == torch.float32 and first is screen.reading
    screen.track(beam.transformed_to(mu_x=2e-4))
    assert not torch.equal(first, screen.reading)
    screen.set_read_beam(None)
    assert torch.equal(screen.reading, torch.zeros(30, 40))


# ----------------------------------------------------------------------------
# BPM and Aperture
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["particle", "parameter"])
def test_bpm_reading(kind):
    jax_beam = _jax_beam()
    if kind == "parameter":
        jax_beam = jax_beam.as_parameter_beam()
        beam = parameter_beam_to_torch(jax_beam)
    else:
        beam = beam_to_torch(jax_beam)
    misalignment = [1e-5, 2e-5]
    jax_bpm = ct.BPM(is_active=True, misalignment=jnp.asarray(misalignment))
    bpm = ctt.BPM(is_active=True, misalignment=misalignment, dtype=F64, device=CPU)
    assert torch.isnan(bpm.reading).all() and bpm.reading.shape == (2,)
    assert bpm.track(beam) is beam
    expected = jit_call(lambda m, b: m.observe(b), jax_bpm, jax_beam)
    np.testing.assert_allclose(bpm.reading.numpy(), np.asarray(expected), rtol=RTOL)
    assert ctt.BPM(dtype=F64, device=CPU).is_skippable


@pytest.mark.parametrize("shape", ["rectangular", "elliptical"])
def test_aperture(shape):
    jax_beam = _jax_beam()
    jax_aperture = ct.Aperture(x_max=jnp.asarray(3e-4), y_max=jnp.asarray(2e-4), shape=shape)
    aperture = segment_to_torch(ct.Segment([jax_aperture])).elements[0]
    expected = jit_call(lambda a, b: a.track(b), jax_aperture, jax_beam)
    actual = aperture.track(beam_to_torch(jax_beam))
    np.testing.assert_array_equal(actual.survival_probabilities.numpy(),
                                  np.asarray(expected.survival_probabilities))
    assert 0 < actual.num_particles_survived.item() < 2000
    parameter_beam = actual.as_parameter_beam()
    with pytest.warns(PhysicsWarning, match="ParticleBeam"):
        assert aperture.track(parameter_beam) is parameter_beam
    aperture.is_active = False
    beam = beam_to_torch(jax_beam)
    assert aperture.is_skippable and aperture.track(beam) is beam


# ----------------------------------------------------------------------------
# track_with_readings and the beam along a segment
# ----------------------------------------------------------------------------


def _jax_diagnostic_segment():
    f64 = jnp.float64
    nested = ct.Segment(
        [
            ct.Drift(jnp.asarray(0.2, f64), name="nd1"),
            ct.BPM(is_active=True, name="nested_bpm"),
            ct.Quadrupole(jnp.asarray(0.1, f64), k1=jnp.asarray(-2.0, f64), name="nq1"),
        ],
        name="nested",
    )
    return ct.Segment(
        [
            ct.Drift(jnp.asarray(1.0, f64), name="d1"),
            ct.Quadrupole(jnp.asarray(0.3, f64), k1=jnp.asarray(3.0, f64), name="q1"),
            nested,
            ct.BPM(is_active=True, name="bpm1"),
            ct.Aperture(x_max=jnp.asarray(6e-4, f64), y_max=jnp.asarray(6e-4, f64), name="ap"),
            ct.Drift(jnp.asarray(0.5, f64), name="d2"),
            ct.Screen(resolution=(32, 32), pixel_size=jnp.asarray([4e-5, 4e-5], f64),
                      method="cloud-in-cell", is_active=True, name="screen1"),
            ct.Drift(jnp.asarray(0.3, f64), name="d3"),
        ],
        name="diag",
    )


@pytest.mark.parametrize("kind", ["particle", "parameter"])
def test_track_with_readings(kind):
    jax_segment = _jax_diagnostic_segment()
    segment = segment_to_torch(jax_segment)
    jax_beam = _jax_beam()
    if kind == "parameter":
        jax_beam = jax_beam.as_parameter_beam()
        beam = parameter_beam_to_torch(jax_beam)
    else:
        beam = beam_to_torch(jax_beam)
    with pytest.warns(PhysicsWarning) if kind == "parameter" else contextlib.nullcontext():
        out, readings = segment.track_with_readings(beam)
    with pytest.warns(JaxPhysicsWarning) if kind == "parameter" else contextlib.nullcontext():
        expected_out, expected = jit_call(lambda s, b: s.track_with_readings(b), jax_segment,
                                          jax_beam)
    # The JAX package's dict comes back from jit with its keys sorted.
    assert list(readings) == ["nested_bpm", "bpm1", "screen1"]
    assert sorted(expected) == sorted(readings)
    for name in readings:
        assert_image_close(readings[name], expected[name], err_msg=name)
    if kind == "particle":
        np.testing.assert_allclose(out.particles.numpy(), np.asarray(expected_out.particles),
                                   rtol=1e-12, atol=1e-18)
        np.testing.assert_array_equal(out.survival_probabilities.numpy(),
                                      np.asarray(expected_out.survival_probabilities))
    assert out.s.item() == pytest.approx(float(expected_out.s), rel=1e-14)
    # The plain track of the same segment reaches the same beam.
    with pytest.warns(PhysicsWarning) if kind == "parameter" else contextlib.nullcontext():
        tracked = segment.track(beam)
    assert out.s.item() == pytest.approx(tracked.s.item(), rel=1e-14)


def test_get_beam_attrs_along_segment():
    jax_segment = _jax_diagnostic_segment()
    segment = segment_to_torch(jax_segment)
    jax_beam = _jax_beam(num_particles=500)
    names = ("s", "sigma_x", "mu_y", "particles")
    actual = segment.get_beam_attrs_along_segment(names, beam_to_torch(jax_beam))
    expected = jit_call(lambda s, b: s.get_beam_attrs_along_segment(names, b), jax_segment,
                        jax_beam)
    for name, got, want in zip(names, actual, expected):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-18,
                                   err_msg=name)
    assert segment.get_beam_attrs_along_segment("s", beam_to_torch(jax_beam)).shape == (9,)
    # resolution= splits the elements first, as in the JAX package (run
    # eagerly there: the split counts its pieces on the host).
    split_names = ("s", "sigma_x")
    actual = segment.get_beam_attrs_along_segment(split_names, beam_to_torch(jax_beam),
                                                  resolution=0.1)
    expected = jax_segment.get_beam_attrs_along_segment(split_names, jax_beam, resolution=0.1)
    for name, got, want in zip(split_names, actual, expected):
        assert got.shape == want.shape and got.shape[-1] > 9, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-18,
                                   err_msg=name)


def test_grad_screen_centroid_matches_jax():
    """d(centroid on AREABSCR1) / d k1 of AREAMQZM1 (``centroid_loss`` of
    ``scripts/bench_all.py``) with the cloud-in-cell screen at binning 4."""
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64, screen=True)
    jax_segment.AREABSCR1.binning = 4
    segment = ares_ea_subcell(F64, device=CPU, screen=True)
    segment.AREABSCR1.binning = 4
    jax_beam = _jax_beam(num_particles=2000, mu_x=0.0, seed=3)
    beam = beam_to_torch(jax_beam)

    def jax_loss(k1, jax_segment, jax_beam):
        jax_segment.AREAMQZM1.k1 = k1
        _, readings = jax_segment.track_with_readings(jax_beam)
        centers_x, _ = jax_segment.AREABSCR1.pixel_bin_centers
        column_mass = jnp.sum(readings["AREABSCR1"], axis=-2)
        return jnp.sum(column_mass * centers_x) / jnp.sum(column_mass)

    k1 = torch.tensor(4.0, dtype=F64, requires_grad=True)
    segment.AREAMQZM1.k1 = k1
    _, readings = segment.track_with_readings(beam)
    centers_x, _ = segment.AREABSCR1.pixel_bin_centers
    column_mass = torch.sum(readings["AREABSCR1"], dim=-2)
    value = torch.sum(column_mass * centers_x) / torch.sum(column_mass)
    (grad,) = torch.autograd.grad(value, k1)
    expected_value, expected_grad = jit_call(jax.value_and_grad(jax_loss), jnp.asarray(4.0),
                                             jax_segment, jax_beam)
    assert value.item() == pytest.approx(float(expected_value), rel=RTOL)
    assert grad.item() == pytest.approx(float(expected_grad), rel=1e-9)
    assert grad.item() != 0.0
