"""Diagnostic screen (counterpart of ``cheetah_tpu/accelerator/screen.py``)."""

from __future__ import annotations

import math

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    ZeroLengthMixin,
    identity_transfer_map,
)
from cheetah_tpu_torch.ops.cloud_in_cell import (
    cloud_in_cell_charge_deposition,
    fixed_point_index_add,
)
from cheetah_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import as_float_tensor
from cheetah_tpu_torch.utils.elementwise_linspace import linspace
from cheetah_tpu_torch.utils.kde import kde_histogram_2d

METHODS = ("histogram", "kde", "cloud-in-cell")

#: KDE screens with more pixels than this evaluate their kernels on a
#: window of ``KDE_WINDOW`` x ``KDE_WINDOW`` pixels around the beam.
KDE_WINDOW = 512
KDE_WINDOW_MIN_PIXELS = 4 * KDE_WINDOW * KDE_WINDOW


class Screen(ZeroLengthMixin, Element):
    """Diagnostic screen producing a camera image of the beam, of shape
    ``(..., height, width)``.

    Image methods, all vectorised over the beam's and the screen's vector
    dimensions:

    - ``"histogram"``: each particle's weight to its pixel; the right-most
      edges belong to the last pixels. Piecewise constant in the positions,
      so their gradients are zero (the charges' flow).
    - ``"cloud-in-cell"`` (default): bilinear weights to the four nearest
      pixel centres; differentiable in the positions.
    - ``"kde"``: a Gaussian kernel of ``kde_bandwidth`` per particle;
      smooth, and much more expensive. Screens of more than
      ``KDE_WINDOW_MIN_PIXELS`` pixels evaluate it on a window around an
      unbatched beam where the beam fits one (:mod:`cheetah_tpu_torch.utils.kde`).

    A ``ParameterBeam`` reads as its transverse Gaussian pdf on the grid
    ``extent[0] + pixel_width * binning * arange(width)`` (and likewise in
    y), as in the JAX package, not on the pixel centres.

    :meth:`observe` is the functional readout, which
    ``Segment.track_with_readings`` collects; tracking an active screen also
    keeps the beam it saw, and ``screen.reading`` is its image.

    :param resolution: Camera sensor resolution ``(width, height)`` in
        pixels.
    :param pixel_size: Pixel size ``(width, height)`` in m.
    :param binning: Camera binning.
    :param misalignment: Screen misalignment ``(x, y)`` in m, of shape
        ``(..., 2)``.
    :param method: ``"histogram"``, ``"kde"`` or ``"cloud-in-cell"``.
    :param kde_bandwidth: KDE bandwidth in m (defaults to the pixel width).
    :param is_blocking: Whether the screen stops the beam.
    :param is_active: Whether the screen records the beam.
    :param name: Unique identifier of the element.
    :param device: Device for sizes given as Python numbers; the GPU when
        ``None``.
    """

    def __init__(
        self,
        resolution: tuple[int, int] = (1024, 1024),
        pixel_size: torch.Tensor | tuple | None = None,
        binning: int = 1,
        misalignment: torch.Tensor | tuple | None = None,
        method: str = "cloud-in-cell",
        kde_bandwidth: torch.Tensor | float | None = None,
        is_blocking: bool = False,
        is_active: bool = False,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        if not (isinstance(resolution, (tuple, list)) and len(resolution) == 2):
            raise ValueError("Invalid resolution. Must be a tuple of 2 integers.")
        if method not in METHODS:
            raise ValueError(
                f"Invalid method {method}. Must be 'histogram', 'kde', or 'cloud-in-cell'."
            )
        super().__init__()
        self._register_parameters(
            ("pixel_size", pixel_size if pixel_size is not None else (1e-3, 1e-3)),
            dtype,
            device,
            misalignment=misalignment if misalignment is not None else (0.0, 0.0),
        )
        self.register_buffer(
            "kde_bandwidth",
            as_float_tensor(
                kde_bandwidth if kde_bandwidth is not None else self.pixel_size[0].clone(),
                dtype=self.pixel_size.dtype,
                device=self.pixel_size.device,
            ),
        )
        self.resolution = tuple(int(r) for r in resolution)
        self.binning = binning
        self.method = method
        self.is_blocking = is_blocking
        self.is_active = is_active
        self._read_beam = None
        self._cached_reading = None
        self._init_element(name, sanitize_name, metadata)

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    @property
    def effective_resolution(self) -> tuple[int, int]:
        return (self.resolution[0] // self.binning, self.resolution[1] // self.binning)

    @property
    def effective_pixel_size(self) -> torch.Tensor:
        return self.pixel_size * self.binning

    @property
    def extent(self) -> torch.Tensor:
        """``(x_min, x_max, y_min, y_max)`` of the sensor in m."""
        return torch.stack(
            [
                -self.resolution[0] * self.pixel_size[0] / 2,
                self.resolution[0] * self.pixel_size[0] / 2,
                -self.resolution[1] * self.pixel_size[1] / 2,
                self.resolution[1] * self.pixel_size[1] / 2,
            ]
        )

    @property
    def pixel_bin_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Pixel edges in x and y, as ``jnp.linspace`` computes them
        (:func:`cheetah_tpu_torch.utils.elementwise_linspace.linspace`)."""
        x_min, x_max, y_min, y_max = self.extent
        return (
            linspace(x_min, x_max, self.effective_resolution[0] + 1),
            linspace(y_min, y_max, self.effective_resolution[1] + 1),
        )

    @property
    def pixel_bin_centers(self) -> tuple[torch.Tensor, torch.Tensor]:
        edges_x, edges_y = self.pixel_bin_edges
        return ((edges_x[1:] + edges_x[:-1]) / 2, (edges_y[1:] + edges_y[:-1]) / 2)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return identity_transfer_map(energy)

    def _track(self, incoming: Beam) -> Beam:
        if not self.is_active:
            return incoming
        self.set_read_beam(self._misalignment_shifted(incoming))
        if not self.is_blocking:
            return incoming
        # A blocking screen takes all of the beam's charge.
        if isinstance(incoming, ParameterBeam):
            return ParameterBeam(
                incoming.mu,
                incoming.cov,
                incoming.energy,
                total_charge=torch.zeros_like(incoming.total_charge),
                s=incoming.s,
                species=incoming.species,
            )
        return ParticleBeam(
            incoming.particles,
            incoming.energy,
            particle_charges=incoming.particle_charges,
            survival_probabilities=torch.zeros_like(incoming.survival_probabilities),
            s=incoming.s,
            species=incoming.species,
        )

    def _misalignment_shifted(self, incoming: Beam) -> Beam:
        """The beam as the screen sees it, shifted by the misalignment; a
        vectorised misalignment of shape ``(..., 2)`` broadcasts against the
        beam's own vector dimensions."""
        misalignment = self.misalignment
        zero = torch.zeros_like(misalignment[..., 0])
        shift = torch.stack(
            [misalignment[..., 0], zero, misalignment[..., 1], zero, zero, zero, zero], dim=-1
        )
        if isinstance(incoming, ParameterBeam):
            shift = shift.to(incoming.mu.dtype)
            return ParameterBeam(
                incoming.mu - shift,
                incoming.cov,
                incoming.energy,
                total_charge=incoming.total_charge,
                s=incoming.s,
                species=incoming.species,
            )
        if isinstance(incoming, ParticleBeam):
            shift = shift.to(incoming.particles.dtype)
            return ParticleBeam(
                incoming.particles - shift[..., None, :],
                incoming.energy,
                particle_charges=incoming.particle_charges,
                survival_probabilities=incoming.survival_probabilities,
                s=incoming.s,
                species=incoming.species,
            )
        raise TypeError(f"Incoming beam is of invalid type {type(incoming)}")

    def observe(self, incoming: Beam) -> torch.Tensor:
        """The camera image the screen records for ``incoming``, of shape
        ``(..., height, width)``."""
        return self._image_of(self._misalignment_shifted(incoming))

    @property
    def reading(self) -> torch.Tensor:
        """Image of the last beam an active screen was tracked with; zeros
        before any."""
        if self._cached_reading is None:
            if self._read_beam is None:
                self._cached_reading = torch.zeros(
                    (self.effective_resolution[1], self.effective_resolution[0]),
                    dtype=self.misalignment.dtype,
                    device=self.misalignment.device,
                )
            else:
                self._cached_reading = self._image_of(self._read_beam)
        return self._cached_reading

    def get_read_beam(self) -> Beam | None:
        return self._read_beam

    def set_read_beam(self, value: Beam | None) -> None:
        self._read_beam = value
        self._cached_reading = None

    def _image_of(self, read_beam: Beam) -> torch.Tensor:
        if isinstance(read_beam, ParameterBeam):
            return self._gaussian_image(read_beam)
        if not isinstance(read_beam, ParticleBeam):
            raise TypeError(f"Read beam is of invalid type {type(read_beam)}")
        weights = torch.abs(read_beam.particle_charges) * read_beam.survival_probabilities
        x, y, weights = torch.broadcast_tensors(read_beam.x, read_beam.y, weights)
        if self.method == "histogram":
            image = self._histogram(x, y, weights)
        elif self.method == "kde":
            centers_x, centers_y = self.pixel_bin_centers
            nx, ny = self.effective_resolution
            image = kde_histogram_2d(
                x1=x,
                x2=y,
                bins1=centers_x,
                bins2=centers_y,
                bandwidth=self.kde_bandwidth,
                weights=weights,
                window=KDE_WINDOW if nx * ny > KDE_WINDOW_MIN_PIXELS else None,
            )
        else:
            image = cloud_in_cell_charge_deposition(
                positions=torch.stack([x, y], dim=-1),
                bins=self.effective_resolution,
                extent=self.extent.reshape(2, 2),
                charges=weights,
            )
        return image.transpose(-1, -2)

    def _gaussian_image(self, read_beam: ParameterBeam) -> torch.Tensor:
        """The beam's transverse 2D Gaussian pdf, ``(..., height, width)``."""
        cov = read_beam.cov
        transverse_cov = torch.stack(
            [
                torch.stack([cov[..., 0, 0], cov[..., 0, 2]], dim=-1),
                torch.stack([cov[..., 2, 0], cov[..., 2, 2]], dim=-1),
            ],
            dim=-1,
        )
        chol = torch.linalg.cholesky(transverse_cov)
        l00 = chol[..., 0, 0, None, None]
        l10 = chol[..., 1, 0, None, None]
        l11 = chol[..., 1, 1, None, None]
        extent = self.extent
        nx, ny = self.effective_resolution
        xs = extent[0] + self.pixel_size[0] * self.binning * torch.arange(
            nx, dtype=extent.dtype, device=extent.device
        )
        ys = extent[2] + self.pixel_size[1] * self.binning * torch.arange(
            ny, dtype=extent.dtype, device=extent.device
        )
        # Whitened offsets of each pixel from the mean, (..., nx, ny).
        white_x = (xs[:, None] - read_beam.mu[..., 0, None, None]) / l00
        white_y = (ys[None, :] - read_beam.mu[..., 2, None, None] - l10 * white_x) / l11
        log_pdf = (
            -0.5 * (torch.square(white_x) + torch.square(white_y))
            - math.log(2 * math.pi)
            - torch.log(l00)
            - torch.log(l11)
        )
        return torch.exp(log_pdf).transpose(-1, -2)

    def _histogram(
        self, x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor
    ) -> torch.Tensor:
        """Uniform-grid histogram with one sum over every instance's pixels
        (``fixed_point_index_add``: the same bits on every run),
        ``(..., width, height)``; the right-most edges are in the last
        pixels, as ``histogram2d`` has them."""
        edges_x, edges_y = self.pixel_bin_edges
        nbx, nby = edges_x.shape[0] - 1, edges_y.shape[0] - 1
        batch_shape, num_particles = x.shape[:-1], x.shape[-1]
        x = x.reshape(-1, num_particles)
        y = y.reshape(-1, num_particles)
        weights = weights.reshape(-1, num_particles)
        inside = (x >= edges_x[0]) & (x <= edges_x[-1]) & (y >= edges_y[0]) & (y <= edges_y[-1])

        def pixel(values: torch.Tensor, edges: torch.Tensor, count: int) -> torch.Tensor:
            # The pixel width as the sensor's width over the pixel count.
            # The JAX package takes edges[1] - edges[0], which in float32
            # loses four digits to cancellation on a 2448-pixel sensor
            # (3.31970 against 3.31980 um) and moves ~4% of a beam's
            # particles one pixel; in float64 the two agree to 1e-13.
            index = torch.floor((values - edges[0]) / ((edges[-1] - edges[0]) / count))
            # Outside the sensor (also NaN and inf) the weight is zero;
            # index 0 keeps the conversion to integers defined.
            index = torch.where(inside, index, torch.zeros_like(index))
            return torch.clamp(index.to(torch.int64), 0, count - 1)

        offsets = torch.arange(x.shape[0], device=x.device)[:, None] * (nbx * nby)
        index = offsets + pixel(x, edges_x, nbx) * nby + pixel(y, edges_y, nby)
        image = fixed_point_index_add(
            index.reshape(-1), (weights * inside).reshape(-1), x.shape[0] * nbx * nby
        )
        return image.reshape(*batch_shape, nbx, nby)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "resolution",
            "pixel_size",
            "binning",
            "misalignment",
            "method",
            "kde_bandwidth",
            "is_active",
        ]
