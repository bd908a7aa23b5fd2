"""Matplotlib visualisation of lattices and beams (counterpart of
``cheetah_tpu/plotting.py``).

The same figures as the JAX package's: the per-element lattice cartoon (a
style registry keyed by class name), the ``Segment.plot*`` family and the
``ParticleBeam.plot*`` family. Every value leaves its device through
``.detach().cpu()`` before it reaches numpy or matplotlib, so beams and
lattices on the GPU, and parameters that require grad, plot as they are.

The numbers each figure draws come from the functions without matplotlib
in this module (:func:`segment_s_positions`,
:func:`beam_attrs_along_segment`, :func:`histogram_1d`,
:func:`histogram_2d`); matplotlib is imported by the drawing functions
only, so those run where matplotlib is not installed.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cheetah_tpu_torch.particles.particle_beam import ParticleBeam
from cheetah_tpu_torch.utils.vector import squash_index_for_unavailable_dims

PRETTY_DIMENSION_LABELS = ParticleBeam.PRETTY_DIMENSION_LABELS


def _host(value) -> np.ndarray:
    """``value`` as a numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _scalar(value, vector_idx) -> float:
    """A plottable scalar from a possibly vectorised value."""
    value = _host(value)
    if value.ndim > 0:
        idx = squash_index_for_unavailable_dims(vector_idx, value.shape)
        value = value[idx] if idx is not None else value.reshape(-1)[0]
    return float(np.asarray(value).reshape(-1)[0])


def _select(metric: np.ndarray, vector_idx) -> np.ndarray:
    """The instance ``vector_idx`` of a vectorised metric, the first one when
    ``None``, as the lattice cartoon takes it. (The JAX package indexes with
    ``None`` there, which adds a dimension that matplotlib refuses: a
    lattice with vectorised or ``(1,)``-shaped lengths, such as the NX
    Tables import's drifts, does not plot in it.)"""
    if metric.ndim <= 1:
        return metric
    if vector_idx is None:
        return metric.reshape(-1, metric.shape[-1])[0]
    return metric[vector_idx]


# ----------------------------------------------------------------------
# The numbers the figures draw
# ----------------------------------------------------------------------


def segment_s_positions(segment, s=0.0, vector_idx=None) -> np.ndarray:
    """The s positions of the segment's element boundaries, entrance first,
    of the instance ``vector_idx`` (the first when ``None``)."""
    lengths = [element.length.detach() for element in segment.elements]
    stacked = torch.stack(torch.broadcast_tensors(*lengths), dim=-1)
    end_positions = torch.cumsum(stacked, dim=-1)
    s_positions = torch.cat([torch.zeros_like(end_positions[..., :1]), end_positions], dim=-1)
    plot_ss = _host(s_positions + (s.detach() if isinstance(s, torch.Tensor) else s))
    if plot_ss.ndim > 1:
        idx = squash_index_for_unavailable_dims(vector_idx, plot_ss.shape[:-1])
        plot_ss = plot_ss[idx] if idx is not None else plot_ss.reshape(-1, plot_ss.shape[-1])[0]
    return plot_ss


def beam_attrs_along_segment(
    segment, incoming, attr_names: tuple, resolution=None, vector_idx=None, broadcast=False
) -> tuple[np.ndarray, ...]:
    """The beam attributes ``attr_names`` at the entrance and after every
    element (``Segment.get_beam_attrs_along_segment``), on the host, each
    of the instance ``vector_idx`` where it is vectorised. With
    ``broadcast`` the attributes are broadcast against each other first,
    as the mean-and-size plot does."""
    values = segment.get_beam_attrs_along_segment(attr_names, incoming, resolution=resolution)
    if broadcast:
        values = torch.broadcast_tensors(*values)
    return tuple(_select(_host(value), vector_idx) for value in values)


def histogram_1d(beam, dimension, bins=100, bin_range=None, smoothing=0.0):
    """Bin centres and the histogram of one phase-space dimension,
    normalised to its largest bin (Gaussian-smoothed by ``smoothing`` bins
    first)."""
    samples = _host(getattr(beam, dimension))
    histogram, edges = np.histogram(samples, bins=bins, range=bin_range)
    centers = (edges[:-1] + edges[1:]) / 2
    if smoothing:
        from scipy.ndimage import gaussian_filter

        histogram = gaussian_filter(histogram, smoothing)
    return centers, histogram / histogram.max()


def histogram_2d(beam, x_dimension, y_dimension, bins=100, bin_ranges=None):
    """The 2D histogram of two phase-space dimensions and its edges."""
    return np.histogram2d(
        _host(getattr(beam, x_dimension)),
        _host(getattr(beam, y_dimension)),
        bins=bins,
        range=bin_ranges,
    )


# ----------------------------------------------------------------------
# Lattice cartoon
# ----------------------------------------------------------------------

# Class name -> (colour, height rule). Height rules: "signed:<attr>" flips the
# box below the axis for negative strengths; floats are fixed box heights;
# "thin" draws a zero-width vertical marker.
_ELEMENT_STYLES = {
    "Quadrupole": ("tab:red", "signed:k1"),
    "Sextupole": ("tab:orange", "signed:k2"),
    "Dipole": ("tab:green", "signed:angle"),
    "RBend": ("tab:green", "signed:angle"),
    "HorizontalCorrector": ("tab:blue", "signed:angle"),
    "VerticalCorrector": ("tab:cyan", "signed:angle"),
    "CombinedCorrector": ("tab:blue", 0.8),
    "Solenoid": ("tab:orange", 0.8),
    "Undulator": ("tab:purple", 0.4),
    "Cavity": ("gold", 0.4),
    "TransverseDeflectingCavity": ("olive", 0.4),
    "CustomTransferMap": ("tab:olive", 0.4),
    "SpaceChargeKick": ("orange", "line"),
    "BPM": ("darkkhaki", "thin"),
    "Screen": ("tab:green", "thin"),
    "Aperture": ("tab:pink", 0.4),
}


def plot_element(element, s, vector_idx=None, ax=None):
    """Draw a 1D cartoon of ``element`` at position ``s`` (lattice view)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    ax = ax if ax is not None else plt.subplot(111)
    class_name = type(element).__name__

    if class_name in ("Drift", "Marker", "Segment"):
        return ax  # Drawn as gaps on purpose.
    if class_name == "Superimposed":
        return plot_segment_cartoon(element._segment(), s, vector_idx, ax)

    color, height_rule = _ELEMENT_STYLES.get(class_name, ("tab:gray", 0.4))

    plot_s = _scalar(s, vector_idx)
    plot_length = _scalar(element.length, vector_idx)
    is_active = getattr(element, "is_active", True)
    alpha = 1 if is_active else 0.2

    if height_rule == "thin":
        extent = 0.6 if class_name == "Screen" else 0.3
        ax.add_patch(
            Rectangle((plot_s, -extent), 0, 2 * extent, color=color, alpha=alpha, zorder=2)
        )
        return ax
    if height_rule == "line":
        ax.axvline(plot_s, ymin=0.01, ymax=0.99, color=color, linestyle="-")
        return ax

    if isinstance(height_rule, str) and height_rule.startswith("signed:"):
        strength = _scalar(getattr(element, height_rule.split(":")[1]), vector_idx)
        height = 0.8 * (np.sign(strength) if is_active else 1)
        height = height if height != 0 else 0.8
    else:
        height = float(height_rule)

    ax.add_patch(
        Rectangle((plot_s, 0), plot_length, height, color=color, alpha=alpha, zorder=2)
    )
    return ax


def plot_segment_cartoon(segment, s=0.0, vector_idx=None, ax=None):
    """Draw the lattice cartoon of a segment."""
    import matplotlib.pyplot as plt

    ax = ax if ax is not None else plt.subplot(111)
    plot_ss = segment_s_positions(segment, s, vector_idx)

    ax.plot([plot_ss[0], plot_ss[-1]], [0, 0], "--", color="black")
    for element, element_s in zip(segment.elements, plot_ss[:-1]):
        plot_element(element, element_s, vector_idx, ax)

    ax.set_ylim(-1, 1)
    ax.set_xlabel("s (m)")
    ax.set_yticks([])
    return ax


# ----------------------------------------------------------------------
# Beam attributes along a segment
# ----------------------------------------------------------------------


def plot_mean_and_std(segment, incoming, resolution=None, vector_idx=None, axx=None, axy=None):
    """Beam position and size along s in both planes."""
    import matplotlib.pyplot as plt

    if axx is None and axy is None:
        _, (axx, axy) = plt.subplots(2, 1, sharex=True)
    elif axx is None or axy is None:
        raise ValueError("Either provide both axx and axy, or neither.")

    ss, x_means, x_stds, y_means, y_stds = beam_attrs_along_segment(
        segment, incoming, ("s", "mu_x", "sigma_x", "mu_y", "sigma_y"), resolution,
        vector_idx, broadcast=True,
    )

    axx.plot(ss, x_means)
    axx.fill_between(ss, x_means - x_stds, x_means + x_stds, alpha=0.4)
    axy.plot(ss, y_means)
    axy.fill_between(ss, y_means - y_stds, y_means + y_stds, alpha=0.4)

    axx.set_xlabel("s (m)")
    axx.set_ylabel("x (m)")
    axy.set_xlabel("s (m)")
    axy.set_ylabel("y (m)")
    return axx, axy


def plot_overview(segment, incoming, resolution=None, vector_idx=None, fig=None):
    """Lattice cartoon under the beam position and size plots."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure()
    gs = fig.add_gridspec(3, hspace=0, height_ratios=[2, 2, 1])
    axs = gs.subplots(sharex=True)

    axs[0].set_title("Beam Position and Size")
    plot_mean_and_std(
        segment, incoming, resolution=resolution, vector_idx=vector_idx, axx=axs[0], axy=axs[1]
    )
    plot_segment_cartoon(segment, 0.0, vector_idx, axs[2])
    return fig


def plot_beam_attrs(segment, incoming, attr_names, resolution=None, vector_idx=None, ax=None):
    """Arbitrary beam attributes along s."""
    import matplotlib.pyplot as plt

    names = ("s",) + (attr_names if isinstance(attr_names, tuple) else (attr_names,))
    s, *beam_attrs = beam_attrs_along_segment(segment, incoming, names, resolution, vector_idx)
    ax = ax if ax is not None else plt.subplot(111)

    for attr, attr_name in zip(beam_attrs, names[1:]):
        ax.plot(s, attr, label=attr_name)
    ax.legend()
    return ax


def plot_beam_attrs_over_lattice(
    segment, incoming, attr_names, resolution=None, vector_idx=None, fig=None
):
    """Beam attributes over a lattice cartoon."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure(figsize=(8, 4))
    gs = fig.add_gridspec(2, hspace=0, height_ratios=[3, 1])
    axs = gs.subplots(sharex=True)
    plot_beam_attrs(
        segment, incoming, attr_names, resolution=resolution, vector_idx=vector_idx, ax=axs[0]
    )
    plot_segment_cartoon(segment, 0.0, vector_idx, axs[1])
    return fig


def plot_twiss(segment, incoming, vector_idx=None, ax=None):
    """Twiss beta functions along s."""
    ax = plot_beam_attrs(
        segment, incoming, ("beta_x", "beta_y"), resolution=None, vector_idx=vector_idx, ax=ax
    )
    beta_x_line, beta_y_line = ax.get_lines()[:2]
    beta_x_line.set_label(r"$\beta_x$")
    beta_x_line.set_color("tab:red")
    beta_y_line.set_label(r"$\beta_y$")
    beta_y_line.set_color("tab:green")

    ax.set_title("Twiss Parameters")
    ax.set_xlabel("s (m)")
    ax.set_ylabel(r"$\beta$ (m)")
    ax.legend()
    return ax


def plot_twiss_over_lattice(segment, incoming, vector_idx=None, fig=None):
    """Twiss plot over a lattice cartoon."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure(figsize=(8, 4))
    gs = fig.add_gridspec(2, hspace=0, height_ratios=[3, 1])
    axs = gs.subplots(sharex=True)
    plot_twiss(segment, incoming, vector_idx=vector_idx, ax=axs[0])
    plot_segment_cartoon(segment, 0.0, vector_idx, axs[1])
    return fig


# ----------------------------------------------------------------------
# ParticleBeam distribution plots
# ----------------------------------------------------------------------


def plot_1d_distribution(
    beam, dimension, bins=100, bin_range=None, smoothing=0.0, plot_kws=None, ax=None
):
    """1D histogram of one phase-space dimension."""
    import matplotlib.pyplot as plt

    from cheetah_tpu_torch.utils.plot import format_axis_with_prefixed_unit

    if ax is None:
        _, ax = plt.subplots()

    centers, normalized = histogram_1d(beam, dimension, bins, bin_range, smoothing)
    ax.plot(centers, normalized, **{"color": "black"} | (plot_kws or {}))
    ax.set_xlabel(PRETTY_DIMENSION_LABELS[dimension])
    if dimension in ("x", "y", "tau"):
        format_axis_with_prefixed_unit(ax.xaxis, "m", centers)
    return ax


def plot_2d_distribution(
    beam,
    x_dimension,
    y_dimension,
    style="histogram",
    bins=100,
    bin_ranges=None,
    histogram_smoothing=0.0,
    contour_smoothing=3.0,
    pcolormesh_kws=None,
    contour_kws=None,
    ax=None,
):
    """2D histogram or contour of two phase-space dimensions."""
    import matplotlib.pyplot as plt
    from scipy.ndimage import gaussian_filter

    from cheetah_tpu_torch.utils.plot import format_axis_with_prefixed_unit

    if ax is None:
        _, ax = plt.subplots()

    histogram, x_edges, y_edges = histogram_2d(beam, x_dimension, y_dimension, bins, bin_ranges)
    x_centers = (x_edges[:-1] + x_edges[1:]) / 2
    y_centers = (y_edges[:-1] + y_edges[1:]) / 2

    smoothed = gaussian_filter(histogram, histogram_smoothing)
    clipped = np.where(smoothed > 1, smoothed, np.nan)
    if style == "histogram":
        ax.pcolormesh(
            x_edges,
            y_edges,
            clipped.T / smoothed.max(),
            **{"cmap": "rainbow"} | (pcolormesh_kws or {}),
        )
    elif style == "contour":
        contour_histogram = gaussian_filter(histogram, contour_smoothing)
        ax.contour(
            x_centers,
            y_centers,
            contour_histogram.T / contour_histogram.max(),
            **{"levels": 3} | (contour_kws or {}),
        )

    ax.set_xlabel(PRETTY_DIMENSION_LABELS[x_dimension])
    ax.set_ylabel(PRETTY_DIMENSION_LABELS[y_dimension])
    if x_dimension in ("x", "y", "tau"):
        format_axis_with_prefixed_unit(ax.xaxis, "m", x_centers)
    if y_dimension in ("x", "y", "tau"):
        format_axis_with_prefixed_unit(ax.yaxis, "m", y_centers)
    return ax


def plot_distribution(
    beam,
    dimensions=("x", "px", "y", "py", "tau", "p"),
    bins=100,
    bin_ranges=None,
    plot_1d_kws=None,
    plot_2d_kws=None,
    axs=None,
):
    """Corner plot: 1D histograms on the diagonal, 2D projections below.

    :param bin_ranges: One ``(low, high)`` for every dimension, one per
        dimension, ``"unit_same"`` (one range for the spatial and one for
        the unitless dimensions) or ``None`` (each dimension's range padded
        by a tenth).
    """
    import matplotlib.pyplot as plt

    if axs is None:
        fig, axs = plt.subplots(
            len(dimensions),
            len(dimensions),
            figsize=(2 * len(dimensions), 2 * len(dimensions)),
        )
    else:
        fig = axs[0, 0].figure
        if axs.shape != (len(dimensions), len(dimensions)):
            raise ValueError(f"axs of shape {axs.shape} for {len(dimensions)} dimensions.")

    full = np.stack([_host(getattr(beam, dimension)) for dimension in dimensions], axis=-2)

    def padded_range(values):
        pad = (values.max() - values.min()) / 10
        return (values.min() - pad, values.max() + pad)

    if bin_ranges is None:
        bin_ranges = [padded_range(full[i, :]) for i in range(full.shape[-2])]
    elif bin_ranges == "unit_same":
        spatial = [i for i, d in enumerate(dimensions) if d in ("x", "y", "tau")]
        unitless = [i for i, d in enumerate(dimensions) if d in ("px", "py", "p")]
        per_dimension = {}
        if spatial:
            spatial_range = padded_range(full[spatial, :])
            per_dimension |= {"x": spatial_range, "y": spatial_range, "tau": spatial_range}
        if unitless:
            unitless_range = padded_range(full[unitless, :])
            per_dimension |= {"px": unitless_range, "py": unitless_range, "p": unitless_range}
        bin_ranges = [per_dimension[d] for d in dimensions]
    if np.asarray(bin_ranges, dtype=object).shape == (2,):
        bin_ranges = [bin_ranges] * len(dimensions)
    if len(bin_ranges) != len(dimensions):
        raise ValueError(f"{len(bin_ranges)} bin ranges for {len(dimensions)} dimensions.")

    for i, dimension in enumerate(dimensions):
        plot_1d_distribution(
            beam, dimension, bins=bins, bin_range=bin_ranges[i], ax=axs[i, i],
            **(plot_1d_kws or {}),
        )
    for i, j in itertools.combinations(range(len(dimensions)), 2):
        plot_2d_distribution(
            beam,
            dimensions[i],
            dimensions[j],
            bins=bins,
            bin_ranges=(bin_ranges[i], bin_ranges[j]),
            ax=axs[j, i],
            **(plot_2d_kws or {}),
        )
        axs[i, j].set_visible(False)

    for ax_column in axs.T:
        for ax in ax_column[0:-1]:
            ax.sharex(ax_column[0])
            ax.xaxis.set_tick_params(labelbottom=False)
            ax.set_xlabel(None)
    for i, ax_row in enumerate(axs):
        for ax in ax_row[1:i]:
            ax.sharey(ax_row[0])
            ax.yaxis.set_tick_params(labelleft=False)
            ax.set_ylabel(None)
    for i in range(len(dimensions)):
        axs[i, i].sharey(axs[0, 0])
        axs[i, i].set_yticks([])
        axs[i, i].set_ylabel(None)

    return fig, axs


def plot_point_cloud(beam, scatter_kws=None, ax=None):
    """3D scatter of the spatial particle coordinates, coloured by delta."""
    import matplotlib.pyplot as plt

    from cheetah_tpu_torch.utils.plot import format_axis_with_prefixed_unit

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")

    x = _host(beam.x)
    tau = _host(beam.tau)
    y = _host(beam.y)
    ax.scatter(x, tau, y, c=_host(beam.p), **(scatter_kws or {}))
    ax.set_xlabel(PRETTY_DIMENSION_LABELS["x"])
    ax.set_ylabel(PRETTY_DIMENSION_LABELS["tau"])
    ax.set_zlabel(PRETTY_DIMENSION_LABELS["y"])
    format_axis_with_prefixed_unit(ax.xaxis, "m", x)
    format_axis_with_prefixed_unit(ax.yaxis, "m", tau)
    format_axis_with_prefixed_unit(ax.zaxis, "m", y)
    return ax
