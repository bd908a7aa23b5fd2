"""Space-charge kick (counterpart of ``cheetah_tpu/accelerator/space_charge_kick.py``).

Integrated-Green-function (Hockney) FFT solver in the lab frame with a
gamma-scaled longitudinal coordinate:

1. Deposit the charge onto a ``grid_shape`` grid sized to the beam sigmas
   (the CIC deposit kernel, :mod:`cheetah_tpu_torch.ops.cloud_in_cell`).
2. Solve the modified Poisson equation by convolving with the tabulated
   integrated Green function on a 2x zero-padded grid (``torch.fft.rfftn``).
3. Central-difference the potential into force fields (scaled by -1/gamma^2).
4. Gather the forces to the particles with the trilinear gather kernel and
   apply the momentum kick ``p += F dt``.

Two bin-space conventions meet here, as in the JAX package: the deposit uses
cell centres (``(pos - left) * scale - 0.5``) and the gather uses nodes
(``(pos + grid_dimensions) / cell_size``). The JAX package's two gathers
(two-hot contraction and 8-corner take) compute the same trilinear values;
the port has one.

With ``particle_axis`` the kick runs explicit SPMD over the particle axis
(the JAX package's ``shard_map`` mode): each rank tracks its own particles,
and two differentiable all-reduces
(:func:`cheetah_tpu_torch.parallel.collectives.all_reduce`) join them, the
sums of the grid-sizing moments and the deposited grid. The deposit, the
replicated Poisson solve and the gather run on the rank's own tensors, on
the same kernels as without the axis.
"""

from __future__ import annotations

import math

import torch

from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.constants import elementary_charge, epsilon_0, speed_of_light
from cheetah_tpu_torch.ops import cic_kernels
from cheetah_tpu_torch.ops.cloud_in_cell import cloud_in_cell_charge_deposition, grid_counts
from cheetah_tpu_torch.particles import ParticleBeam
from cheetah_tpu_torch.utils.device import constant_cache


def _all_reduce(tensor: torch.Tensor, axis) -> torch.Tensor:
    """:func:`cheetah_tpu_torch.parallel.collectives.all_reduce`, imported
    on first use: the multi-device layer (``torch.distributed``'s meshes and
    tensors) is not loaded with the package."""
    from cheetah_tpu_torch.parallel import collectives

    return collectives.all_reduce(tensor, axis)


@constant_cache
def _momentum_columns(device: torch.device) -> torch.Tensor:
    return torch.tensor([1, 3, 5], device=device)


class SpaceChargeKick(Element):
    """Applies the integrated space-charge momentum kick over ``effect_length``.

    :param effect_length: Length over which the effect is applied in m.
    :param grid_shape: Grid points in (x, y, tau).
    :param grid_extent_x: Grid half-extent in x as a multiple of sigma_x.
    :param grid_extent_y: Grid half-extent in y as a multiple of sigma_y.
    :param grid_extent_tau: Grid half-extent in tau as a multiple of
        sigma_tau.
    :param particle_axis: The axis over which the beam's particles are
        sharded: a mesh axis name, a tuple of names (resolved on the mesh of
        :func:`cheetah_tpu_torch.parallel.active_mesh`) or a
        ``torch.distributed`` process group. Each rank then passes its own
        particles; the grid-sizing moment sums and the deposited grid are
        all-reduced over the axis, and the rest stays local. ``None`` (the
        default): the beam holds all the particles.
    :param name: Unique identifier of the element.
    :param device: Device for parameters given as Python numbers; the GPU
        when ``None``.

    Gradients with ``particle_axis``: each rank calls backward on its own
    share of the loss (the terms of its own particles, scaled as in the
    global loss, e.g. divided by the global particle count); the kick's
    all-reduces carry the other ranks' terms in backward; then the
    gradients of replicated parameters (``effect_length``, a ``k1``) are
    all-reduced (summed) over the axis. Backward on an all-reduced global
    loss instead counts it once per rank.
    """

    def __init__(
        self,
        effect_length: torch.Tensor | float,
        grid_shape: tuple[int, int, int] = (32, 32, 32),
        grid_extent_x: torch.Tensor | float | None = None,
        grid_extent_y: torch.Tensor | float | None = None,
        grid_extent_tau: torch.Tensor | float | None = None,
        particle_axis=None,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(
            ("effect_length", effect_length),
            dtype,
            device,
            grid_extent_x=grid_extent_x if grid_extent_x is not None else 3.0,
            grid_extent_y=grid_extent_y if grid_extent_y is not None else 3.0,
            grid_extent_tau=grid_extent_tau if grid_extent_tau is not None else 3.0,
        )
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.particle_axis = particle_axis
        self._init_element(name, sanitize_name, metadata)

    @property
    def length(self) -> torch.Tensor:
        return self.effect_length.new_zeros(())

    @property
    def is_skippable(self) -> bool:
        return False

    def clone(self) -> "SpaceChargeKick":
        cloned = super().clone()
        cloned.particle_axis = self.particle_axis
        return cloned

    def _global_weighted_std(self, values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """Unbiased weighted std over the rank's particles (the last
        dimension) combined over ``particle_axis``: the moment-sum form of
        ``unbiased_weighted_std``, exact up to rounding, its four sums
        all-reduced in one call. ``values`` may stack several quantities in
        front of ``weights``' dimensions."""
        weights = weights.expand_as(values)
        sums = torch.stack(
            [
                torch.sum(weights, dim=-1),
                torch.sum(weights * values, dim=-1),
                torch.sum(weights * torch.square(values), dim=-1),
                torch.sum(torch.square(weights), dim=-1),
            ]
        )
        sw, swx, swx2, sw2 = _all_reduce(sums, self.particle_axis)
        mean = swx / sw
        correction = sw - sw2 / sw
        return torch.sqrt((swx2 - sw * torch.square(mean)) / correction)

    # ------------------------------------------------------------------
    # Green function
    # ------------------------------------------------------------------

    @staticmethod
    def _integrated_potential(
        x: torch.Tensor, y: torch.Tensor, tau: torch.Tensor
    ) -> torch.Tensor:
        """Closed-form integrated potential; evaluated only at half-cell
        offsets, where all arguments are nonzero."""
        r = torch.sqrt(torch.square(x) + torch.square(y) + torch.square(tau))
        return (
            -0.5 * torch.square(tau) * torch.arctan(x * y / (tau * r))
            - 0.5 * torch.square(y) * torch.arctan(x * tau / (y * r))
            - 0.5 * torch.square(x) * torch.arctan(y * tau / (x * r))
            + y * tau * torch.asinh(x / torch.sqrt(torch.square(y) + torch.square(tau)))
            + x * tau * torch.asinh(y / torch.sqrt(torch.square(x) + torch.square(tau)))
            + x * y * torch.asinh(tau / torch.sqrt(torch.square(x) + torch.square(y)))
        )

    def _integrated_green_function(
        self, gamma: torch.Tensor, cell_size: torch.Tensor
    ) -> torch.Tensor:
        """Tabulate the IGF on the (nx+1, ny+1, nt+1) half-integer corner
        grid, take the 3D mixed difference, and mirror it into all octants of
        the doubled grid."""
        nx, ny, nt = self.grid_shape
        dx = cell_size[..., 0]
        dy = cell_size[..., 1]
        # Longitudinal dimension scaled by gamma: modified Poisson equation in
        # the lab frame.
        dt = cell_size[..., 2] * gamma

        def corners(n: int) -> torch.Tensor:
            return torch.arange(n + 1, dtype=cell_size.dtype, device=cell_size.device) - 0.5

        ix, iy, it = torch.meshgrid(corners(nx), corners(ny), corners(nt), indexing="ij")

        def bc(v: torch.Tensor) -> torch.Tensor:
            return v[..., None, None, None]

        Phi = self._integrated_potential(ix * bc(dx), iy * bc(dy), it * bc(dt))

        lo, hi = slice(None, -1), slice(1, None)
        G = (
            Phi[..., hi, hi, hi]
            - Phi[..., lo, hi, hi]
            - Phi[..., hi, lo, hi]
            - Phi[..., hi, hi, lo]
            + Phi[..., hi, lo, lo]
            + Phi[..., lo, hi, lo]
            + Phi[..., lo, lo, hi]
            - Phi[..., lo, lo, lo]
        )

        # Open-boundary Hockney layout per axis: [G, zero plane, flip(G[1:])].
        def mirror(a: torch.Tensor, dim: int) -> torch.Tensor:
            shape = list(a.shape)
            shape[dim] = 1
            zero = a.new_zeros(shape)
            body = torch.flip(a.narrow(dim, 1, a.shape[dim] - 1), (dim,))
            return torch.cat([a, zero, body], dim)

        return mirror(mirror(mirror(G, -1), -2), -3)

    # ------------------------------------------------------------------
    # Poisson solve
    # ------------------------------------------------------------------

    def _charge_density(
        self,
        beam: ParticleBeam,
        positions: torch.Tensor,
        cell_size: torch.Tensor,
        grid_dimensions: torch.Tensor,
    ) -> torch.Tensor:
        """CIC deposit, normalised to density, zero-padded to the 2x grid."""
        charge_grid = cloud_in_cell_charge_deposition(
            positions=positions,
            bins=self.grid_shape,
            extent=torch.stack([-grid_dimensions, grid_dimensions], dim=-1),
            charges=beam.particle_charges * beam.survival_probabilities,
        )
        if self.particle_axis is not None:
            # Each rank deposited its own particles; the grid is their sum.
            charge_grid = _all_reduce(charge_grid, self.particle_axis)
        # Not torch.prod: its backward looks for zero factors with
        # ``nonzero``, a device sync in every backward that no CUDA graph
        # can capture.
        inv_cell_volume = 1.0 / (cell_size[..., 0] * cell_size[..., 1] * cell_size[..., 2])
        charge_density = charge_grid * inv_cell_volume[..., None, None, None]

        nx, ny, nt = self.grid_shape
        # Out of place (zeros after each axis), so that torch.func transforms it.
        return torch.nn.functional.pad(charge_density, (0, nt, 0, ny, 0, nx))

    def _solve_poisson_equation(
        self,
        beam: ParticleBeam,
        positions: torch.Tensor,
        cell_size: torch.Tensor,
        grid_dimensions: torch.Tensor,
    ) -> torch.Tensor:
        """FFT convolution on the 2x grid, cropped to the physical octant."""
        rho = self._charge_density(beam, positions, cell_size, grid_dimensions)
        igf = self._integrated_green_function(beam.relativistic_gamma, cell_size)

        dims = (-3, -2, -1)
        potential_ft = torch.fft.rfftn(rho, dim=dims) * torch.fft.rfftn(igf, dim=dims)
        potential = (1.0 / (4 * math.pi * epsilon_0)) * torch.fft.irfftn(
            potential_ft, s=rho.shape[-3:], dim=dims
        )
        nx, ny, nt = self.grid_shape
        return potential[..., :nx, :ny, :nt]

    def _force_fields(
        self,
        beam: ParticleBeam,
        positions: torch.Tensor,
        cell_size: torch.Tensor,
        grid_dimensions: torch.Tensor,
    ) -> torch.Tensor:
        """Central-difference force fields with zero boundaries, scaled by
        ``-1/gamma^2``, stacked as ``(B, 3, nx, ny, nt)``."""
        gamma = beam.relativistic_gamma
        gamma_safe = torch.where(gamma != 0, gamma, torch.ones_like(gamma))
        igamma2 = torch.where(
            gamma != 0, 1.0 / torch.square(gamma_safe), torch.zeros_like(gamma)
        )
        potential = self._solve_poisson_equation(
            beam, positions, cell_size, grid_dimensions
        )

        def central_diff(p: torch.Tensor, dim: int, inv_h: torch.Tensor) -> torch.Tensor:
            upper = torch.roll(p, -1, dims=dim)
            lower = torch.roll(p, 1, dims=dim)
            grad = (upper - lower) * (0.5 * inv_h[..., None, None, None])
            # Zero boundary conditions on the differentiated axis.
            n = p.shape[dim]
            index = torch.arange(n, device=p.device)
            interior = (index > 0) & (index < n - 1)
            shape = [1, 1, 1]
            shape[dim] = n
            return grad * interior.reshape(shape)

        inv_cell = 1.0 / cell_size
        scale = -igamma2[..., None, None, None]
        return torch.stack(
            [scale * central_diff(potential, dim, inv_cell[..., axis])
             for axis, dim in enumerate((-3, -2, -1))],
            dim=1,
        )

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------

    def _track(self, incoming: ParticleBeam) -> ParticleBeam:
        if not isinstance(incoming, ParticleBeam):
            raise TypeError(
                "SpaceChargeKick tracking is currently only supported for `ParticleBeam`."
            )
        # Sub-f32 beams compute the collective effect in f32 and cast back:
        # the FFT has no sub-f32 path that fits, and the density deposit would
        # be meaningless at 8 mantissa bits.
        in_dtype = incoming.particles.dtype
        if in_dtype in (torch.bfloat16, torch.float16):
            upcast = incoming.to(dtype=torch.float32)
            tracked = self._track(upcast)
            return ParticleBeam(
                particles=tracked.particles.to(in_dtype),
                energy=tracked.energy.to(incoming.energy.dtype),
                particle_charges=incoming.particle_charges,
                survival_probabilities=incoming.survival_probabilities,
                s=tracked.s.to(incoming.s.dtype),
                species=incoming.species,
            )

        # Flatten all vector dims to one batch dim (reversed at the end).
        outgoing_vector_shape = torch.broadcast_shapes(
            incoming.particles.shape[:-2],
            incoming.energy.shape,
            incoming.particle_charges.shape[:-1],
            incoming.survival_probabilities.shape[:-1],
            self.effect_length.shape,
        )
        vector_shape = torch.broadcast_shapes(outgoing_vector_shape, (1,))
        n = incoming.num_particles
        flattened = ParticleBeam(
            particles=incoming.particles.expand(*vector_shape, n, 7).reshape(-1, n, 7),
            energy=incoming.energy.expand(vector_shape).reshape(-1),
            particle_charges=incoming.particle_charges.expand(*vector_shape, n).reshape(-1, n),
            survival_probabilities=incoming.survival_probabilities.expand(
                *vector_shape, n
            ).reshape(-1, n),
            # The incoming s, though unused here: a default would be built
            # from a Python number on the host on every call.
            s=incoming.s,
            species=incoming.species,
        )
        effect_length = self.effect_length.expand(vector_shape).reshape(-1)

        # Grid geometry from the beam sigmas (the single-pass raw moments);
        # over a particle axis, from the global moments, so that every rank
        # sizes the same grid.
        if self.particle_axis is not None:
            sigma_x, sigma_y, sigma_tau = self._global_weighted_std(
                torch.stack([flattened.x, flattened.y, flattened.tau]),
                flattened.survival_probabilities,
            )
        else:
            sigma_x, sigma_y, sigma_tau = flattened.sigma_x, flattened.sigma_y, flattened.sigma_tau
        grid_dimensions = torch.stack(
            [
                self.grid_extent_x * sigma_x,
                self.grid_extent_y * sigma_y,
                self.grid_extent_tau * sigma_tau,
            ],
            dim=-1,
        )
        cell_size = 2 * grid_dimensions / grid_counts(
            self.grid_shape, grid_dimensions.dtype, grid_dimensions.device
        )
        dt = effect_length / (speed_of_light * flattened.relativistic_beta)

        xp_coordinates = flattened.to_xyz_pxpypz()
        # x, y, z: a strided view, no index tensor to copy to the card.
        positions = xp_coordinates[..., 0:5:2]
        grids = self._force_fields(flattened, positions, cell_size, grid_dimensions)
        normalized = (positions + grid_dimensions[..., None, :]) / cell_size[..., None, :]
        (values,) = cic_kernels.differentiable_gather(grids, normalized, cic_kernels.VALUE)
        forces = values * elementary_charge  # (B, 3, N)

        # The kick adds to the momenta (columns 1, 3, 5), out of place.
        xp_coordinates = xp_coordinates.index_add(
            -1, _momentum_columns(xp_coordinates.device),
            (forces * dt[:, None, None]).transpose(1, 2),
        )

        return ParticleBeam.from_xyz_pxpypz(
            xp_coordinates=xp_coordinates.reshape(*outgoing_vector_shape, n, 7),
            energy=incoming.energy,
            particle_charges=incoming.particle_charges,
            survival_probabilities=incoming.survival_probabilities,
            s=incoming.s,
            species=incoming.species,
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "effect_length",
            "grid_shape",
            "grid_extent_x",
            "grid_extent_y",
            "grid_extent_tau",
        ]
