"""Macroparticle beam (counterpart of ``cheetah_tpu/particles/particle_beam.py``).

A ``ParticleBeam`` is a plain object holding tensors on one device:
``particles`` of shape ``(..., num_particles, 7)``, per-macroparticle charges
and survival probabilities of shape ``(..., num_particles)``, and the
reference ``energy`` and position ``s``. Leading vector dimensions broadcast
through all operations. All statistics are survival-probability weighted.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch import constants
from cheetah_tpu_torch.particles import _moments
from cheetah_tpu_torch.particles.beam import Beam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import (
    as_float_tensor,
    infer_dtype_device,
    same_device,
)
from cheetah_tpu_torch.utils.statistics import match_distribution_moments


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
    # Statistics
    # ------------------------------------------------------------------

    @property
    def num_particles(self) -> int:
        """Number of macroparticles (ignoring losses)."""
        return self.particles.shape[-2]

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
        in-place version counters.
        """
        weights = self.survival_probabilities
        particles = self.particles
        key = (particles._version, weights._version)
        cached = getattr(self, "_moments_cache", None)
        if (
            cached is not None
            and cached[0] is particles
            and cached[1] is weights
            and cached[2] == key
        ):
            return cached[3]

        total = torch.sum(weights, dim=-1)
        w_row = weights.unsqueeze(-2)
        s1 = torch.matmul(w_row, particles).squeeze(-2)
        s2 = torch.matmul(w_row, torch.square(particles)).squeeze(-2)
        mean = s1 / total[..., None]
        correction = total - torch.sum(torch.square(weights), dim=-1) / total
        variance = (
            torch.clamp(s2 - total[..., None] * torch.square(mean), min=0.0)
            / correction[..., None]
        )
        self._moments_cache = (particles, weights, key, (mean, variance))
        return mean, variance

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

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(particles={tuple(self.particles.shape)}, "
            f"energy={self.energy!r}, device={self.particles.device}, "
            f"species={self.species.name!r})"
        )
