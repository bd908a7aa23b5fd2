"""The port's plots against cheetah_tpu's, under Agg, on the CPU in float64.

Each plot of ``tests/test_plotting.py`` is drawn by both packages from the
same lattice and the same particles (drawn with numpy): every line's data
(``get_xydata``), the element cartoon's rectangles, the filled bands, the
2D histograms' meshes and the point cloud's points must agree within rtol
1e-10. The port's plots also draw from parameters that require grad.
"""

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.collections import PolyCollection, QuadMesh  # noqa: E402
from matplotlib.patches import Rectangle  # noqa: E402

import cheetah_tpu as ct  # noqa: E402
import cheetah_tpu_torch as ctt  # noqa: E402
from cheetah_tpu_torch import interop, plotting  # noqa: E402

CPU = "cpu"
F64 = torch.float64
RTOL = 1e-10


def build_segment(package, **kw):
    """The lattice of ``tests/test_plotting.py`` in ``package``."""
    return package.Segment(
        [
            package.Drift(1.0, name="d1", **kw),
            package.Quadrupole(0.3, k1=4.2, name="q1", **kw),
            package.HorizontalCorrector(0.1, angle=1e-4, name="hc", **kw),
            package.Dipole(0.3, angle=0.1, name="b1", **kw),
            package.Sextupole(0.2, k2=30.0, name="s1", tracking_method="linear", **kw),
            package.Cavity(0.5, name="c1", **kw),
            package.BPM(name="bpm1", **({"device": CPU} if kw else {})),
            package.Screen(name="scr1", **({"device": CPU} if kw else {})),
            package.Marker(name="m1", **({"device": CPU} if kw else {})),
            package.Drift(0.5, name="d2", **kw),
        ],
        name="plotting_test",
    )


def jax_segment():
    return build_segment(ct)


def port_segment():
    return build_segment(ctt, dtype=F64, device=CPU)


@pytest.fixture(scope="module")
def arrays():
    """A Gaussian beam of 2000 particles with beta 5 / 3 m and emittance
    2e-9 in both planes, at 150 MeV."""
    rng = np.random.default_rng(0)
    sigmas = np.array([1e-4, 2e-5, 7.7e-5, 2.6e-5, 1e-5, 1e-3])
    particles = np.concatenate([rng.normal(size=(2000, 6)) * sigmas, np.ones((2000, 1))], -1)
    return particles


def jax_beam(particles):
    return ct.ParticleBeam(particles=jnp.asarray(particles), energy=jnp.asarray(1.5e8),
                           particle_charges=jnp.full(particles.shape[0], 1e-14))


def port_beam(values, **parameters):
    beam = interop.particle_beam_from_numpy(
        values, np.asarray(1.5e8), np.full(values.shape[0], 1e-14),
        np.ones(values.shape[0]), device=CPU,
    )
    for name, value in parameters.items():
        setattr(beam, name, value)
    return beam


def figure_data(figure) -> list:
    """Everything a figure draws, as numpy arrays, axes by axes."""
    data = []
    for ax in figure.axes:
        data.append({
            "lines": [line.get_xydata() for line in ax.get_lines()],
            "rectangles": [
                np.array([patch.get_x(), patch.get_y(), patch.get_width(), patch.get_height()])
                for patch in ax.patches if isinstance(patch, Rectangle)
            ],
            "bands": [np.concatenate([path.vertices for path in collection.get_paths()])
                      for collection in ax.collections if isinstance(collection, PolyCollection)],
            "meshes": [np.ma.filled(collection.get_array(), np.nan)
                       for collection in ax.collections if isinstance(collection, QuadMesh)],
            "points": [np.asarray(collection._offsets3d) for collection in ax.collections
                       if hasattr(collection, "_offsets3d")],
            "labels": (ax.get_xlabel(), ax.get_ylabel()),
        })
    return data


def assert_same_figures(port_figure, jax_figure) -> None:
    ours, theirs = figure_data(port_figure), figure_data(jax_figure)
    assert len(ours) == len(theirs)
    for our_ax, their_ax in zip(ours, theirs):
        assert our_ax["labels"] == their_ax["labels"]
        for kind in ("lines", "rectangles", "bands", "meshes", "points"):
            assert len(our_ax[kind]) == len(their_ax[kind]), kind
            for a, b in zip(our_ax[kind], their_ax[kind]):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-300, err_msg=kind)
    plt.close("all")


def _figure(result):
    if isinstance(result, tuple):
        result = result[0]
    return result if isinstance(result, matplotlib.figure.Figure) else result.figure


SEGMENT_PLOTS = {
    "plot": lambda segment, beam: segment.plot(),
    "mean_and_std": lambda segment, beam: segment.plot_mean_and_std(beam),
    "overview": lambda segment, beam: segment.plot_overview(beam),
    "twiss": lambda segment, beam: segment.plot_twiss(beam),
    "twiss_over_lattice": lambda segment, beam: segment.plot_twiss_over_lattice(beam),
    "beam_attrs": lambda segment, beam: segment.plot_beam_attrs(beam, ("sigma_x", "sigma_y")),
    "beam_attrs_over_lattice": lambda segment, beam: segment.plot_beam_attrs_over_lattice(
        beam, "emittance_x"),
    "overview_resolution": lambda segment, beam: segment.plot_overview(beam, resolution=0.1),
}


@pytest.mark.parametrize("name", SEGMENT_PLOTS)
def test_segment_plots_match_jax(name, arrays):
    draw = SEGMENT_PLOTS[name]
    plt.close("all")
    theirs = _figure(draw(jax_segment(), jax_beam(arrays)))
    plt.figure()
    ours = _figure(draw(port_segment(), port_beam(arrays)))
    assert_same_figures(ours, theirs)


def test_vectorised_segment_plot_matches_jax(arrays):
    jax_seg, port_seg = jax_segment(), port_segment()
    jax_seg.q1.k1 = jnp.linspace(-5, 5, 3, dtype=jnp.float64)
    port_seg.q1.k1 = torch.linspace(-5, 5, 3, dtype=F64)
    for vector_idx in ((1,), (2,)):
        theirs = _figure(jax_seg.plot_mean_and_std(jax_beam(arrays), vector_idx=vector_idx))
        ours = _figure(port_seg.plot_mean_and_std(port_beam(arrays), vector_idx=vector_idx))
        assert_same_figures(ours, theirs)
        theirs = _figure(jax_seg.plot(vector_idx=vector_idx))
        plt.figure()
        ours = _figure(port_seg.plot(vector_idx=vector_idx))
        assert_same_figures(ours, theirs)


BEAM_PLOTS = {
    "1d": lambda beam: beam.plot_1d_distribution("x"),
    "1d_smoothed": lambda beam: beam.plot_1d_distribution("p", smoothing=2.0, bins=50),
    "2d": lambda beam: beam.plot_2d_distribution("x", "px"),
    "2d_contour": lambda beam: beam.plot_2d_distribution("x", "y", style="contour"),
    "point_cloud": lambda beam: beam.plot_point_cloud(),
    "corner": lambda beam: beam.plot_distribution(dimensions=("x", "px", "y")),
    "corner_unit_same": lambda beam: beam.plot_distribution(dimensions=("x", "y"),
                                                            bin_ranges="unit_same"),
}


@pytest.mark.parametrize("name", BEAM_PLOTS)
def test_beam_plots_match_jax(name, arrays):
    draw = BEAM_PLOTS[name]
    plt.close("all")
    theirs = _figure(draw(jax_beam(arrays)))
    ours = _figure(draw(port_beam(arrays)))
    assert_same_figures(ours, theirs)


def test_plots_draw_from_parameters_that_require_grad(arrays):
    """A beam and a magnet that require grad plot as their detached values
    do (every value leaves through ``.detach().cpu()``)."""
    segment = port_segment()
    segment.q1.k1 = torch.tensor(4.2, dtype=F64, requires_grad=True)
    particles = torch.tensor(arrays, dtype=F64, requires_grad=True)
    beam = port_beam(arrays, particles=particles * 1.0)
    ours = _figure(segment.plot_overview(beam))
    theirs = _figure(jax_segment().plot_overview(jax_beam(arrays)))
    assert_same_figures(ours, theirs)
    ours = _figure(beam.plot_distribution(dimensions=("x", "px")))
    theirs = _figure(jax_beam(arrays).plot_distribution(dimensions=("x", "px")))
    assert_same_figures(ours, theirs)


def test_plot_data_functions_need_no_matplotlib(arrays):
    """The numbers the figures draw come from functions that import no
    matplotlib; they equal what the figures show."""
    segment, beam = port_segment(), port_beam(arrays)
    ss, mu_x, sigma_x = plotting.beam_attrs_along_segment(segment, beam, ("s", "mu_x", "sigma_x"))
    axx, _ = segment.plot_mean_and_std(beam)
    np.testing.assert_array_equal(axx.get_lines()[0].get_xydata(), np.stack([ss, mu_x], -1))
    positions = plotting.segment_s_positions(segment)
    np.testing.assert_allclose(positions[-1], 2.9, rtol=1e-15)
    centers, histogram = plotting.histogram_1d(beam, "x")
    ax = beam.plot_1d_distribution("x")
    np.testing.assert_array_equal(ax.get_lines()[0].get_xydata(), np.stack([centers, histogram], -1))
    plt.close("all")


def test_imported_lattice_with_one_instance_lengths_plots(arrays):
    """The NX Tables import's drifts have lengths of shape ``(1,)``. The JAX
    package's ``plot_overview`` indexes its metrics with ``None`` and
    matplotlib refuses the result; the port plots the first instance, as
    the cartoon takes it, and draws the tracked moments."""
    from pathlib import Path

    segment = ctt.Segment.from_nx_tables(Path(__file__).parent / "resources" / "Stage4v3_9.txt",
                                         dtype=F64, device=CPU)
    beam = port_beam(arrays)
    figure = segment.plot_overview(beam)
    ss, mu_x = figure.axes[0].get_lines()[0].get_xydata().T
    attrs = segment.get_beam_attrs_along_segment(("s", "mu_x"), beam)
    np.testing.assert_array_equal(ss, attrs[0][0].numpy())
    np.testing.assert_array_equal(mu_x, attrs[1][0].numpy())
    assert len(ss) == len(segment.elements) + 1
    plt.close("all")
