"""Macroparticle beam (counterpart of ``cheetah_tpu/particles/particle_beam.py``).

A ``ParticleBeam`` is a plain object holding tensors on one device:
``particles`` of shape ``(..., num_particles, 7)``, per-macroparticle charges
and survival probabilities of shape ``(..., num_particles)``, and the
reference ``energy`` and position ``s``. Leading vector dimensions broadcast
through all operations. All statistics are survival-probability weighted.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from cheetah_tpu_torch import constants
from cheetah_tpu_torch.particles import _moments
from cheetah_tpu_torch.particles.beam import Beam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import (
    as_float_tensor,
    infer_dtype_device,
    resolve_device,
    same_device,
)
from cheetah_tpu_torch.utils.elementwise_linspace import elementwise_linspace
from cheetah_tpu_torch.utils.profiling import count
from cheetah_tpu_torch.utils.statistics import (
    match_distribution_moments,
    unbiased_weighted_covariance,
    unbiased_weighted_covariance_matrix,
)

_COMPONENTS = ("x", "px", "y", "py", "tau", "p")


def _component(index: int, name: str) -> property:
    def getter(self) -> torch.Tensor:
        return self.particles[..., index]

    def setter(self, value: torch.Tensor) -> None:
        particles = self.particles.clone()
        particles[..., index] = value
        self.particles = particles

    return property(getter, setter, doc=f"Per-particle {name} coordinate.")


def _mean(index: int, name: str) -> property:
    return property(
        lambda self: self._component_moments()[0][..., index], doc=f"Mean of {name}."
    )


def _std(index: int, name: str) -> property:
    return property(
        lambda self: torch.sqrt(self._component_moments()[1][..., index]),
        doc=f"Standard deviation of {name}.",
    )


def _cov(first: int, second: int, name: str) -> property:
    return property(
        lambda self: unbiased_weighted_covariance(
            self.particles[..., first], self.particles[..., second],
            self.survival_probabilities,
        ),
        doc=f"Weighted covariance {name}.",
    )


def _weighted_sums(
    particles: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The weighted sums ``sum_n w_n p_n`` and ``sum_n w_n p_n^2`` of each
    column of ``particles``, shapes ``(..., 7)``: two batched
    vector-matrix products, with the squared particles as their one
    temporary."""
    w_row = weights.unsqueeze(-2)
    s1 = torch.matmul(w_row, particles).squeeze(-2)
    s2 = torch.matmul(w_row, torch.square(particles)).squeeze(-2)
    return s1, s2


def _finish_moments(
    s1: torch.Tensor, s2: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean and unbiased variance of each column from its sums
    (:func:`_weighted_sums`, or the fused transport's), by the raw-moment
    identity ``Var = E[x^2] - mu^2`` clamped at 0."""
    total = torch.sum(weights, dim=-1)
    mean = s1 / total[..., None]
    correction = total - torch.sum(torch.square(weights), dim=-1) / total
    variance = (
        torch.clamp(s2 - total[..., None] * torch.square(mean), min=0.0)
        / correction[..., None]
    )
    return mean, variance


def _weighted_moments(
    particles: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean and unbiased variance of each column of ``particles``
    (:meth:`ParticleBeam._component_moments`)."""
    return _finish_moments(*_weighted_sums(particles, weights), weights)


class ParticleBeam(Beam):
    """Beam of charged macroparticles.

    :param particles: Particle vectors of shape ``(..., num_particles, 7)``.
    :param energy: Reference energy of the beam in eV.
    :param particle_charges: Charges of the macroparticles in C, shape
        ``(..., num_particles)``.
    :param survival_probabilities: Per-particle survival probability in
        ``[0, 1]``. Defaults to ones.
    :param s: Position along the beamline of the reference particle in m.
    :param species: Particle species of the beam. Defaults to electron.

    Every tensor must lie on the device of ``particles``; a tensor on another
    device raises instead of being moved.
    """

    UNVECTORIZED_NUM_ATTR_DIMS = Beam.UNVECTORIZED_NUM_ATTR_DIMS | {
        "particles": 2,
        "particle_charges": 1,
        "survival_probabilities": 1,
        **{component: 1 for component in _COMPONENTS},
    }

    PRETTY_DIMENSION_LABELS = {
        "x": r"$x$",
        "px": r"$p_x$",
        "y": r"$y$",
        "py": r"$p_y$",
        "tau": r"$\tau$",
        "p": r"$\delta$",
    }

    def __init__(
        self,
        particles: torch.Tensor,
        energy: torch.Tensor | float,
        particle_charges: torch.Tensor | None = None,
        survival_probabilities: torch.Tensor | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        particles = as_float_tensor(particles, dtype=dtype, device=device)
        if particles.shape[-2] == 0 or particles.shape[-1] != 7:
            raise ValueError("Particle vectors must be 7-dimensional.")
        dtype, device = particles.dtype, particles.device

        if species is None:
            species = Species("electron", dtype=dtype, device=device)
        elif not same_device(species.mass_eV.device, device):
            raise ValueError(
                f"Species tensors are on {species.mass_eV.device}, particles on {device}."
            )
        self.species = species
        self.particles = particles
        self.energy = as_float_tensor(energy, dtype=dtype, device=device)
        num_particles = particles.shape[-2]
        self.particle_charges = (
            as_float_tensor(particle_charges, dtype=dtype, device=device)
            if particle_charges is not None
            else species.charge_coulomb.to(dtype).expand(num_particles)
        )
        self.survival_probabilities = (
            as_float_tensor(survival_probabilities, dtype=dtype, device=device)
            if survival_probabilities is not None
            else torch.ones(num_particles, dtype=dtype, device=device)
        )
        self.s = as_float_tensor(s if s is not None else 0.0, dtype=dtype, device=device)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_parameters(
        cls,
        num_particles: int = 100_000,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        **moments: torch.Tensor | float | None,
    ) -> "ParticleBeam":
        """Generate a random Gaussian beam from named first and second moments
        (``mu_x``, ..., ``sigma_x``, ..., ``cov_xpx``, ..., ``cov_pytau``).

        :param generator: Random number generator for the sample; the global
            generator of ``device`` when ``None``.
        """
        dtype, device = infer_dtype_device(
            [energy, total_charge, s, *moments.values()], dtype, device
        )
        params = _moments.resolve_parameters(dtype, device, **moments)
        return cls.from_distribution(
            mu=_moments.build_mu(params),
            cov=_moments.build_cov(params),
            num_particles=num_particles,
            energy=energy,
            total_charge=total_charge,
            s=s,
            species=species,
            generator=generator,
            dtype=dtype,
            device=device,
        )

    @classmethod
    def from_distribution(
        cls,
        mu: torch.Tensor,
        cov: torch.Tensor,
        num_particles: int = 100_000,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Generate a random beam from a 6D multivariate normal distribution.

        Samples a standard normal and transforms it affinely so that the
        sample moments match ``mu`` and ``cov`` *exactly* (Cholesky
        whiten-and-recolour).
        """
        dtype, device = infer_dtype_device([mu, cov, energy, total_charge], dtype, device)
        mu = as_float_tensor(mu, dtype=dtype, device=device)
        cov = as_float_tensor(cov, dtype=dtype, device=device)
        if species is None:
            species = Species("electron", dtype=dtype, device=device)

        energy = as_float_tensor(
            energy if energy is not None else 1e8, dtype=dtype, device=device
        )
        if total_charge is None:
            total_charge = species.charge_coulomb.to(dtype) * num_particles
        else:
            total_charge = as_float_tensor(total_charge, dtype=dtype, device=device)
        particle_charges = (
            torch.ones((*total_charge.shape, num_particles), dtype=dtype, device=device)
            * total_charge[..., None]
            / num_particles
        )

        standard = torch.randn(
            (num_particles, 6), generator=generator, dtype=dtype, device=device
        )
        matched_6d = match_distribution_moments(standard, mu, cov)
        particles = torch.cat([matched_6d, torch.ones_like(matched_6d[..., :1])], dim=-1)
        return cls(
            particles, energy, particle_charges=particle_charges, s=s, species=species
        )

    @classmethod
    def from_twiss(
        cls,
        num_particles: int = 100_000,
        beta_x: torch.Tensor | float | None = None,
        alpha_x: torch.Tensor | float | None = None,
        emittance_x: torch.Tensor | float | None = None,
        beta_y: torch.Tensor | float | None = None,
        alpha_y: torch.Tensor | float | None = None,
        emittance_y: torch.Tensor | float | None = None,
        sigma_tau: torch.Tensor | float | None = None,
        sigma_p: torch.Tensor | float | None = None,
        cov_taup: torch.Tensor | float | None = None,
        dispersion_x: torch.Tensor | float | None = None,
        dispersion_px: torch.Tensor | float | None = None,
        dispersion_y: torch.Tensor | float | None = None,
        dispersion_py: torch.Tensor | float | None = None,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Generate a random beam from Twiss parameters."""
        twiss = {
            "beta_x": (beta_x, 1.0),
            "alpha_x": (alpha_x, 0.0),
            "emittance_x": (emittance_x, 7.1971891e-13),
            "beta_y": (beta_y, 1.0),
            "alpha_y": (alpha_y, 0.0),
            "emittance_y": (emittance_y, 7.1971891e-13),
            "sigma_tau": (sigma_tau, 1e-6),
            "sigma_p": (sigma_p, 1e-6),
            "cov_taup": (cov_taup, 0.0),
            "dispersion_x": (dispersion_x, 0.0),
            "dispersion_px": (dispersion_px, 0.0),
            "dispersion_y": (dispersion_y, 0.0),
            "dispersion_py": (dispersion_py, 0.0),
        }
        dtype, device = infer_dtype_device(
            [value for value, _ in twiss.values()] + [energy, total_charge, s],
            dtype,
            device,
        )
        t = {
            name: as_float_tensor(
                value if value is not None else default, dtype=dtype, device=device
            )
            for name, (value, default) in twiss.items()
        }
        moments = _moments.twiss_to_parameters(
            t["beta_x"],
            t["alpha_x"],
            t["emittance_x"],
            t["beta_y"],
            t["alpha_y"],
            t["emittance_y"],
            t["sigma_p"],
            t["dispersion_x"],
            t["dispersion_px"],
            t["dispersion_y"],
            t["dispersion_py"],
        )
        return cls.from_parameters(
            num_particles=num_particles,
            sigma_tau=t["sigma_tau"],
            sigma_p=t["sigma_p"],
            cov_taup=t["cov_taup"],
            energy=energy,
            total_charge=total_charge,
            s=s,
            species=species,
            generator=generator,
            dtype=dtype,
            device=device,
            **moments,
        )

    @classmethod
    def uniform_3d_ellipsoid(
        cls,
        num_particles: int = 100_000,
        radius_x: torch.Tensor | float | None = None,
        radius_y: torch.Tensor | float | None = None,
        radius_tau: torch.Tensor | float | None = None,
        sigma_px: torch.Tensor | float | None = None,
        sigma_py: torch.Tensor | float | None = None,
        sigma_p: torch.Tensor | float | None = None,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """A waterbag beam: uniform in space inside the ellipsoid of the
        three radii (1 mm each by default), Gaussian in the momenta.

        :param generator: Random number generator for the sample; the global
            generator of ``device`` when ``None``.
        """
        dtype, device = infer_dtype_device(
            [radius_x, radius_y, radius_tau, sigma_px, sigma_py, sigma_p, energy,
             total_charge, s],
            dtype,
            device,
        )
        radius_x, radius_y, radius_tau = (
            as_float_tensor(radius if radius is not None else 1e-3, dtype=dtype, device=device)
            for radius in (radius_x, radius_y, radius_tau)
        )
        beam = cls.from_parameters(
            num_particles=num_particles,
            # The spatial sigmas only give the vector shape: x, y and tau are
            # drawn anew below.
            sigma_x=radius_x,
            sigma_px=sigma_px,
            sigma_y=radius_y,
            sigma_py=sigma_py,
            sigma_tau=radius_tau,
            sigma_p=sigma_p,
            energy=energy,
            total_charge=total_charge,
            s=s,
            species=species,
            generator=generator,
            dtype=dtype,
            device=device,
        )
        particles = beam.particles
        shape = particles.shape[:-1]

        def uniform() -> torch.Tensor:
            return torch.rand(shape, generator=generator, dtype=dtype, device=device)

        # Uniform in the unit ball, in polar coordinates.
        r = uniform() ** (1.0 / 3.0)
        theta = torch.arccos(2.0 * uniform() - 1.0)
        phi = uniform() * (2.0 * math.pi)
        x = r * torch.sin(theta) * torch.cos(phi) * radius_x[..., None]
        y = r * torch.sin(theta) * torch.sin(phi) * radius_y[..., None]
        tau = r * torch.cos(theta) * radius_tau[..., None]
        beam.particles = torch.stack(
            [x, particles[..., 1], y, particles[..., 3], tau, particles[..., 5], particles[..., 6]],
            dim=-1,
        )
        return beam

    @classmethod
    def make_linspaced(
        cls,
        num_particles: int = 10,
        mu_x: torch.Tensor | float | None = None,
        mu_px: torch.Tensor | float | None = None,
        mu_y: torch.Tensor | float | None = None,
        mu_py: torch.Tensor | float | None = None,
        mu_tau: torch.Tensor | float | None = None,
        mu_p: torch.Tensor | float | None = None,
        sigma_x: torch.Tensor | float | None = None,
        sigma_px: torch.Tensor | float | None = None,
        sigma_y: torch.Tensor | float | None = None,
        sigma_py: torch.Tensor | float | None = None,
        sigma_tau: torch.Tensor | float | None = None,
        sigma_p: torch.Tensor | float | None = None,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        particle_charges: torch.Tensor | None = None,
        survival_probabilities: torch.Tensor | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """A beam of evenly spaced particles spanning +-1 sigma in each
        dimension."""
        given = {
            "mu_x": (mu_x, 0.0), "mu_px": (mu_px, 0.0), "mu_y": (mu_y, 0.0),
            "mu_py": (mu_py, 0.0), "mu_tau": (mu_tau, 0.0), "mu_p": (mu_p, 0.0),
            "sigma_x": (sigma_x, 175e-9), "sigma_px": (sigma_px, 2e-7),
            "sigma_y": (sigma_y, 175e-9), "sigma_py": (sigma_py, 2e-7),
            "sigma_tau": (sigma_tau, 1e-6), "sigma_p": (sigma_p, 1e-6),
            "energy": (energy, 1e8),
        }
        dtype, device = infer_dtype_device(
            [value for value, _ in given.values()] + [total_charge, particle_charges, s],
            dtype, device,
        )
        t = {
            name: as_float_tensor(
                value if value is not None else default, dtype=dtype, device=device
            )
            for name, (value, default) in given.items()
        }
        if species is None:
            species = Species("electron", dtype=dtype, device=device)
        if particle_charges is None:
            if total_charge is None:
                total_charge = species.charge_coulomb.to(dtype) * num_particles
            total_charge = as_float_tensor(total_charge, dtype=dtype, device=device)
            particle_charges = (
                torch.ones((*total_charge.shape, num_particles), dtype=dtype, device=device)
                * total_charge[..., None]
                / num_particles
            )
        coords = torch.broadcast_tensors(
            *(
                elementwise_linspace(
                    t[f"mu_{c}"] - t[f"sigma_{c}"], t[f"mu_{c}"] + t[f"sigma_{c}"], num_particles
                )
                for c in _COMPONENTS
            )
        )
        particles = torch.stack([*coords, torch.ones_like(coords[0])], dim=-1)
        return cls(
            particles,
            t["energy"],
            particle_charges=particle_charges,
            survival_probabilities=survival_probabilities,
            s=s,
            species=species,
        )

    @classmethod
    def from_xyz_pxpypz(
        cls,
        xp_coordinates: torch.Tensor,
        energy: torch.Tensor,
        particle_charges: torch.Tensor | None = None,
        survival_probabilities: torch.Tensor | None = None,
        s: torch.Tensor | None = None,
        species: Species | None = None,
        dtype: torch.dtype | None = None,
    ) -> "ParticleBeam":
        """Create a beam from SI phase-space coordinates ``(x, p_x, y, p_y, z,
        p_z, 1)`` (momenta in kg m/s)."""
        beam = cls(
            particles=xp_coordinates,
            energy=energy,
            particle_charges=particle_charges,
            survival_probabilities=survival_probabilities,
            s=s,
            species=species,
            dtype=dtype,
        )
        xp = beam.particles
        gamma0 = beam.relativistic_gamma
        beta0 = beam.relativistic_beta
        p0 = gamma0 * beta0 * beam.species.mass_kg * constants.speed_of_light
        # Normalise by p0 before squaring: SI momenta squared underflow
        # float32; the p0-relative form is exact.
        px_rel = xp[..., 1] / p0[..., None]
        py_rel = xp[..., 3] / p0[..., None]
        pz_rel = xp[..., 5] / p0[..., None]
        p_rel = torch.sqrt(
            torch.square(px_rel) + torch.square(py_rel) + torch.square(pz_rel)
        )
        # p / (m c) = (|p|/p0) * gamma0 * beta0.
        gamma = torch.sqrt(1.0 + torch.square(p_rel * (gamma0 * beta0)[..., None]))

        beam.particles = torch.stack(
            [
                xp[..., 0],
                px_rel,
                xp[..., 2],
                py_rel,
                -xp[..., 4] / beta0[..., None],
                (gamma - gamma0[..., None]) / (beta0 * gamma0)[..., None],
                xp[..., 6],
            ],
            dim=-1,
        )
        return beam

    def to_xyz_pxpypz(self) -> torch.Tensor:
        """Extract SI phase-space coordinates ``(x, p_x, y, p_y, z, p_z, 1)``."""
        gamma0 = self.relativistic_gamma
        beta0 = self.relativistic_beta
        p0 = gamma0 * beta0 * self.species.mass_kg * constants.speed_of_light
        gamma = gamma0[..., None] * (1.0 + self.particles[..., 5] * beta0[..., None])
        beta = torch.sqrt(1.0 - 1.0 / torch.square(gamma))
        # Work in units of p0: SI momenta squared underflow float32. The O(1)
        # ratio |p|/p0 = gamma*beta / (gamma0*beta0) is exact and f32-safe.
        rel_momentum = gamma * beta / (gamma0 * beta0)[..., None]

        px = self.particles[..., 1]
        py = self.particles[..., 3]
        return torch.stack(
            [
                self.particles[..., 0],
                px * p0[..., None],
                self.particles[..., 2],
                py * p0[..., None],
                self.particles[..., 4] * -beta0[..., None],
                p0[..., None]
                * torch.sqrt(
                    torch.square(rel_momentum) - torch.square(px) - torch.square(py)
                ),
                self.particles[..., 6],
            ],
            dim=-1,
        )

    # ------------------------------------------------------------------
    # Import and export
    # ------------------------------------------------------------------

    @classmethod
    def from_astra(
        cls,
        path: str,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Load an ASTRA particle distribution.

        :param device: Device of the beam; the GPU when ``None``.
        """
        from cheetah_tpu_torch.converters.astra import from_astrabeam

        particles, energy, particle_charges = from_astrabeam(path)
        return cls._from_host_arrays(particles, energy, particle_charges, dtype, device)

    @classmethod
    def from_ocelot(
        cls,
        parray,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Convert an Ocelot ``ParticleArray`` (``rparticles`` of shape
        ``(6, N)``, ``E`` in GeV, ``q_array`` in C).

        :param device: Device of the beam; the GPU when ``None``.
        """
        return cls._from_host_arrays(
            np.asarray(parray.rparticles).T, 1e9 * parray.E, np.asarray(parray.q_array),
            dtype, device,
        )

    @classmethod
    def _from_host_arrays(cls, particles, energy, particle_charges, dtype, device):
        """An electron beam from numpy ``(N, 6)`` coordinates, the reference
        energy and the charges."""
        dtype = dtype if dtype is not None else torch.get_default_dtype()
        device = resolve_device(device)
        coordinates = torch.as_tensor(particles, dtype=dtype, device=device)
        ones = torch.ones((coordinates.shape[0], 1), dtype=dtype, device=device)
        return cls(
            particles=torch.cat([coordinates, ones], dim=-1),
            energy=torch.as_tensor(energy, dtype=dtype, device=device),
            particle_charges=torch.as_tensor(particle_charges, dtype=dtype, device=device),
            species=Species("electron", dtype=dtype, device=device),
        )

    @classmethod
    def from_elegant(
        cls,
        file_path,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Load an Elegant SDDS particle distribution.

        :param device: Device of the beam; the GPU when ``None``.
        """
        from pathlib import Path

        from cheetah_tpu_torch.converters import elegant

        particles, energy, particle_charges = elegant.convert_beam(
            Path(file_path), dtype=dtype, device=device
        )
        return cls(
            particles=particles,
            energy=energy,
            particle_charges=particle_charges,
            species=Species("electron", dtype=particles.dtype, device=particles.device),
        )

    @classmethod
    def from_openpmd_file(
        cls,
        path: str,
        energy: torch.Tensor | float,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Load an openPMD particle group HDF5 file.

        Uses ``pmd_beamphysics`` when installed; otherwise the native h5py
        reader of :mod:`cheetah_tpu_torch.converters.openpmd` (the same
        schema).

        :param device: Device of the beam; the GPU when ``None``.
        """
        try:
            import pmd_beamphysics as openpmd

            particle_group = openpmd.ParticleGroup(str(path))
        except ImportError:
            from cheetah_tpu_torch.converters.openpmd import read_particle_group_h5

            particle_group = read_particle_group_h5(path)
        return cls.from_openpmd_particlegroup(particle_group, energy, dtype=dtype, device=device)

    @classmethod
    def from_openpmd_particlegroup(
        cls,
        particle_group,
        energy: torch.Tensor | float,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParticleBeam":
        """Create a beam from an openPMD ``ParticleGroup`` (or the port's
        ``ParticleGroupData``): positions in m, momenta in eV/c, times in s,
        weights in C. Each array is cast to ``dtype`` before the
        arithmetic, as in the JAX package.

        :param device: Device of the beam; the GPU when ``None``.
        """
        dtype = dtype if dtype is not None else torch.get_default_dtype()
        device = resolve_device(device)

        def tensor(values) -> torch.Tensor:
            return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

        species = Species(particle_group.species, dtype=dtype, device=device)
        energy = as_float_tensor(energy, dtype=dtype, device=device)
        p0c = torch.sqrt(torch.square(energy) - torch.square(species.mass_eV))

        x = tensor(particle_group.x)
        particles = torch.stack(
            [
                x,
                tensor(particle_group.px) / p0c,
                tensor(particle_group.y),
                tensor(particle_group.py) / p0c,
                tensor(particle_group.t) * constants.speed_of_light,
                (tensor(particle_group.energy) - energy) / p0c,
                torch.ones_like(x),
            ],
            dim=-1,
        )
        return cls(
            particles=particles,
            energy=energy,
            particle_charges=tensor(particle_group.weight),
            survival_probabilities=tensor(particle_group.status),
            species=species,
        )

    def save_as_openpmd_h5(self, path: str) -> None:
        """Save the beam as an openPMD particle group HDF5 file.

        Uses ``pmd_beamphysics`` when installed; otherwise writes the same
        openPMD BeamPhysics schema with :mod:`cheetah_tpu_torch.converters.openpmd`.
        """
        try:
            self.to_openpmd_particlegroup().write(str(path))
        except ImportError:
            from cheetah_tpu_torch.converters.openpmd import write_particle_group_h5

            write_particle_group_h5(self._to_openpmd_data(), path)

    def _to_openpmd_data(self) -> dict:
        """The beam as an openPMD BeamPhysics data dict of numpy arrays:
        positions in m, momenta in eV/c, time in s, macro charges in C,
        integer status flags (survival probability above 0.5). Computed in
        the beam's dtype on its device, then copied to the host."""
        if self.particles.ndim != 2:
            raise ValueError("Only non-vectorised particle distributions are supported.")

        def host(tensor: torch.Tensor) -> np.ndarray:
            return tensor.detach().cpu().numpy()

        px = self.px * self.p0c
        py = self.py * self.p0c
        p_total = torch.sqrt(torch.square(self.energies) - torch.square(self.species.mass_eV))
        pz = torch.sqrt(torch.square(p_total) - torch.square(px) - torch.square(py))
        return {
            "x": host(self.x),
            "y": host(self.y),
            "z": host(self.tau),
            "px": host(px),
            "py": host(py),
            "pz": host(pz),
            "t": host(self.tau / constants.speed_of_light),
            "weight": host(self.particle_charges),
            "status": host(self.survival_probabilities > 0.5).astype(int),
            "species": self.species.name,
        }

    def to_openpmd_particlegroup(self):
        """Convert to an openPMD ``ParticleGroup``. Unvectorised beams only;
        survival probabilities are thresholded at 0.5 into status flags.

        Requires ``pmd_beamphysics`` (the returned object is its class); for
        file I/O without it use :meth:`save_as_openpmd_h5` and
        :meth:`from_openpmd_file`.
        """
        try:
            import pmd_beamphysics as openpmd
        except ImportError:
            raise ImportError(
                "To use the openPMD beam export, openPMD-beamphysics must be installed."
            )

        return openpmd.ParticleGroup(data=self._to_openpmd_data())

    def to(
        self, device: torch.device | str | None = None, dtype: torch.dtype | None = None
    ) -> "ParticleBeam":
        """Copy of the beam with every tensor on ``device`` and in ``dtype``."""
        return ParticleBeam(
            self.particles.to(device, dtype),
            self.energy.to(device, dtype),
            particle_charges=self.particle_charges.to(device, dtype),
            survival_probabilities=self.survival_probabilities.to(device, dtype),
            s=self.s.to(device, dtype),
            species=self.species.to(device, dtype),
        )

    # ------------------------------------------------------------------
    # Transformations
    # ------------------------------------------------------------------

    def transformed_to(
        self,
        mu_x: torch.Tensor | float | None = None,
        mu_px: torch.Tensor | float | None = None,
        mu_y: torch.Tensor | float | None = None,
        mu_py: torch.Tensor | float | None = None,
        mu_tau: torch.Tensor | float | None = None,
        mu_p: torch.Tensor | float | None = None,
        sigma_x: torch.Tensor | float | None = None,
        sigma_px: torch.Tensor | float | None = None,
        sigma_y: torch.Tensor | float | None = None,
        sigma_py: torch.Tensor | float | None = None,
        sigma_tau: torch.Tensor | float | None = None,
        sigma_p: torch.Tensor | float | None = None,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        species: Species | None = None,
    ) -> "ParticleBeam":
        """This beam shifted and scaled per dimension to new means and
        standard deviations; the others are kept."""
        dtype, device = self.particles.dtype, self.particles.device
        given = {
            "mu_x": mu_x, "mu_px": mu_px, "mu_y": mu_y, "mu_py": mu_py,
            "mu_tau": mu_tau, "mu_p": mu_p, "sigma_x": sigma_x, "sigma_px": sigma_px,
            "sigma_y": sigma_y, "sigma_py": sigma_py, "sigma_tau": sigma_tau,
            "sigma_p": sigma_p,
        }

        def stacked(kind: str, new: bool) -> torch.Tensor:
            values = [
                as_float_tensor(given[f"{kind}_{c}"], dtype=dtype, device=device)
                if new and given[f"{kind}_{c}"] is not None
                else getattr(self, f"{kind}_{c}")
                for c in _COMPONENTS
            ]
            return torch.stack(torch.broadcast_tensors(*values), dim=-1)

        if total_charge is None:
            particle_charges = self.particle_charges
        else:
            total_charge = as_float_tensor(total_charge, dtype=dtype, device=device)
            particle_charges = (
                torch.ones_like(self.particle_charges)
                * total_charge[..., None]
                / self.particle_charges.shape[-1]
            )
        old_mu, new_mu = stacked("mu", False), stacked("mu", True)
        old_sigma, new_sigma = stacked("sigma", False), stacked("sigma", True)
        phase_space = (self.particles[..., :6] - old_mu[..., None, :]) / old_sigma[
            ..., None, :
        ] * new_sigma[..., None, :] + new_mu[..., None, :]
        return self.__class__(
            torch.cat([phase_space, torch.ones_like(phase_space[..., :1])], dim=-1),
            energy if energy is not None else self.energy,
            particle_charges=particle_charges,
            survival_probabilities=self.survival_probabilities,
            s=self.s,
            species=species if species is not None else self.species,
            dtype=dtype,
        )

    def as_parameter_beam(self) -> "ParameterBeam":  # noqa: F821
        """Collapse to a Gaussian-moments :class:`ParameterBeam`: the
        survival-weighted mean and the unbiased weighted covariance of all
        seven coordinates, as the JAX package computes them."""
        from cheetah_tpu_torch.particles.parameter_beam import ParameterBeam

        weights = self.survival_probabilities
        mu = torch.sum(self.particles * weights[..., None], dim=-2) / torch.sum(
            weights, dim=-1, keepdim=True
        )
        return ParameterBeam(
            mu=mu,
            cov=unbiased_weighted_covariance_matrix(self.particles, weights),
            energy=self.energy,
            total_charge=self.total_charge,
            s=self.s,
            species=self.species,
        )

    def linspaced(self, num_particles: int) -> "ParticleBeam":
        """Evenly spaced beam with this beam's means and standard
        deviations."""
        return self.make_linspaced(
            num_particles=num_particles,
            **{f"mu_{c}": getattr(self, f"mu_{c}") for c in _COMPONENTS},
            **{f"sigma_{c}": getattr(self, f"sigma_{c}") for c in _COMPONENTS},
            energy=self.energy,
            total_charge=self.total_charge,
            s=self.s,
            species=self.species,
        )

    def randomly_subsampled(
        self,
        num_particles: int,
        adjust_particle_charges: bool = True,
        generator: torch.Generator | None = None,
    ) -> "ParticleBeam":
        """``num_particles`` macroparticles drawn without replacement.

        :param adjust_particle_charges: Scale the charges so that the
            subsample carries the beam's total charge.
        :param generator: Random number generator for the draw; the global
            generator of the beam's device when ``None``.
        :raises ValueError: if the beam has fewer than ``num_particles``.
        """
        if num_particles > self.num_particles:
            raise ValueError(
                "Number of particles to sample must be less than or equal to the "
                "number of particles in the original beam."
            )
        device = self.particles.device
        indices = torch.randperm(self.num_particles, generator=generator, device=device)[
            :num_particles
        ]
        subsampled = self.__class__(
            self.particles.index_select(-2, indices),
            self.energy,
            particle_charges=self.particle_charges.index_select(-1, indices),
            survival_probabilities=self.survival_probabilities.index_select(-1, indices),
            s=self.s,
            species=self.species,
        )
        if adjust_particle_charges:
            subsampled.particle_charges = subsampled.particle_charges * (
                self.total_charge / subsampled.total_charge
            )[..., None]
        return subsampled

    def clone(self) -> "ParticleBeam":
        """Copy of the beam with every tensor copied."""
        return self.__class__(
            self.particles.clone(),
            self.energy.clone(),
            particle_charges=self.particle_charges.clone(),
            survival_probabilities=self.survival_probabilities.clone(),
            s=self.s.clone(),
            species=self.species.clone(),
        )

    # ------------------------------------------------------------------
    # Statistics
    # ------------------------------------------------------------------

    @property
    def defining_features(self) -> list[str]:
        """Features that define the beam."""
        return [
            "particles",
            "energy",
            "particle_charges",
            "survival_probabilities",
            "s",
            "species",
        ]

    @property
    def num_particles(self) -> int:
        """Number of macroparticles (ignoring losses)."""
        return self.particles.shape[-2]

    @property
    def num_particles_survived(self) -> torch.Tensor:
        """Expected number of surviving macroparticles."""
        return torch.sum(self.survival_probabilities, dim=-1)

    @property
    def total_charge(self) -> torch.Tensor:
        """Total charge in C, accounting for particle losses."""
        return torch.sum(self.particle_charges * self.survival_probabilities, dim=-1)

    def _component_moments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Weighted mean and unbiased variance of all phase-space components
        in one pass over the particle array, shapes ``(..., 7)``.

        Uses the raw-moment identity ``Var = E[x^2] - mu^2``, as the JAX
        package does, so that both give the same numbers. For beams with
        ``|mu| >> sigma`` this costs relative precision ``~eps * (mu/sigma)^2``;
        the variance is clamped at 0. The weighted sums over particles are
        batched vector-matrix products, so no ``(..., N, 7)`` temporary is
        written besides the squared particles.

        Results are memoised for the current ``particles`` and
        ``survival_probabilities`` tensors, keyed on their identity and their
        in-place version counters; a beam that the fused transport made
        starts with its sums in the memo (:meth:`_seed_moments`), so its
        moments read no particle. A pass over the particles counts as
        ``moments_reduction`` (:func:`~cheetah_tpu_torch.utils.profiling.counters`).
        Under ``torch.compile`` there is no memo: a version counter is no
        value a trace can branch on, and the compiler merges the repeated
        sums itself.
        """
        weights = self.survival_probabilities
        particles = self.particles
        if torch.compiler.is_compiling():
            return _weighted_moments(particles, weights)
        key = (particles._version, weights._version)
        cached = getattr(self, "_moments_cache", None)
        if (
            cached is None
            or cached[0] is not particles
            or cached[1] is not weights
            or cached[2] != key
        ):
            count("moments_reduction")
            cached = (particles, weights, key, _weighted_sums(particles, weights), None)
        if cached[4] is None:
            cached = (*cached[:4], _finish_moments(*cached[3], weights))
            self._moments_cache = cached
        return cached[4]

    def _seed_moments(self, s1: torch.Tensor, s2: torch.Tensor) -> None:
        """Put the weighted sums of the current particles (the fused
        transport's, :func:`_weighted_sums`' shapes) in the moment memo,
        keyed as :meth:`_component_moments` keys it: an in-place edit of
        the particles or weights drops them. Nothing under
        ``torch.compile``, which keeps no memo."""
        if torch.compiler.is_compiling():
            return
        particles, weights = self.particles, self.survival_probabilities
        key = (particles._version, weights._version)
        self._moments_cache = (particles, weights, key, (s1, s2), None)

    x = _component(0, "x")
    px = _component(1, "px")
    y = _component(2, "y")
    py = _component(3, "py")
    tau = _component(4, "tau")
    p = _component(5, "p")

    mu_x = _mean(0, "x")
    mu_px = _mean(1, "px")
    mu_y = _mean(2, "y")
    mu_py = _mean(3, "py")
    mu_tau = _mean(4, "tau")
    mu_p = _mean(5, "p")

    sigma_x = _std(0, "x")
    sigma_px = _std(1, "px")
    sigma_y = _std(2, "y")
    sigma_py = _std(3, "py")
    sigma_tau = _std(4, "tau")
    sigma_p = _std(5, "p")

    cov_xpx = _cov(0, 1, "x-px")
    cov_ypy = _cov(2, 3, "y-py")
    cov_taup = _cov(4, 5, "tau-p")
    cov_xp = _cov(0, 5, "x-p")
    cov_pxp = _cov(1, 5, "px-p")
    cov_yp = _cov(2, 5, "y-p")
    cov_pyp = _cov(3, 5, "py-p")
    cov_xy = _cov(0, 2, "x-y")
    cov_xpy = _cov(0, 3, "x-py")
    cov_xtau = _cov(0, 4, "x-tau")
    cov_pxy = _cov(1, 2, "px-y")
    cov_pxpy = _cov(1, 3, "px-py")
    cov_pxtau = _cov(1, 4, "px-tau")
    cov_ytau = _cov(2, 4, "y-tau")
    cov_pytau = _cov(3, 4, "py-tau")

    def __len__(self) -> int:
        return int(self.num_particles)

    @property
    def energies(self) -> torch.Tensor:
        """Energies of the individual particles in eV."""
        return self.p * self.p0c[..., None] + self.energy[..., None]

    @property
    def momenta(self) -> torch.Tensor:
        """Momenta (times c) of the individual particles in eV."""
        return torch.sqrt(torch.square(self.energies) - torch.square(self.species.mass_eV))

    # ------------------------------------------------------------------
    # Visualisation (delegations into cheetah_tpu_torch.plotting)
    # ------------------------------------------------------------------

    def plot_1d_distribution(self, dimension, **kwargs):
        """1D histogram of one phase-space dimension."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_1d_distribution(self, dimension, **kwargs)

    def plot_2d_distribution(self, x_dimension, y_dimension, **kwargs):
        """2D histogram or contour of two phase-space dimensions."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_2d_distribution(self, x_dimension, y_dimension, **kwargs)

    def plot_distribution(self, **kwargs):
        """Corner plot over the phase-space dimensions."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_distribution(self, **kwargs)

    def plot_point_cloud(self, **kwargs):
        """3D scatter of the spatial coordinates, coloured by delta."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_point_cloud(self, **kwargs)

    def __getitem__(self, item: Any) -> "ParticleBeam":
        """The beam at ``item`` of its vector dimensions, every tensor
        broadcast to the beam's vector shape first."""
        vector_shape = torch.broadcast_shapes(
            self.particles.shape[:-2],
            self.energy.shape,
            self.particle_charges.shape[:-1],
            self.survival_probabilities.shape[:-1],
        )
        n = self.num_particles
        return self.__class__(
            self.particles.expand(*vector_shape, n, 7)[item],
            self.energy.expand(vector_shape)[item],
            particle_charges=self.particle_charges.expand(*vector_shape, n)[item],
            survival_probabilities=self.survival_probabilities.expand(*vector_shape, n)[item],
            s=self.s,
            species=self.species,
        )

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(particles={tuple(self.particles.shape)}, "
            f"energy={self.energy!r}, device={self.particles.device}, "
            f"species={self.species.name!r})"
        )
