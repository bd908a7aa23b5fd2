"""Gaussian-moments beam (counterpart of ``cheetah_tpu/particles/parameter_beam.py``).

A ``ParameterBeam`` models the beam as a 7-vector mean ``mu`` and a 7x7
covariance ``cov`` (both with any leading vector dimensions). Tracking it
through a linear map costs one 7-vector product and one 7x7 congruence,
independent of any particle count.
"""

from __future__ import annotations

import numpy as np
import torch

from cheetah_tpu_torch.particles import _moments
from cheetah_tpu_torch.particles.beam import Beam
from cheetah_tpu_torch.particles.particle_beam import ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import (
    as_float_tensor,
    infer_dtype_device,
    resolve_device,
    same_device,
)

_COMPONENTS = ("x", "px", "y", "py", "tau", "p")


def _mean(index: int, name: str) -> property:
    return property(lambda self: self.mu[..., index], doc=f"Mean of {name}.")


def _std(index: int, name: str) -> property:
    return property(
        lambda self: torch.sqrt(self.cov[..., index, index]),
        doc=f"Standard deviation of {name}.",
    )


def _cov(row: int, col: int, name: str) -> property:
    return property(lambda self: self.cov[..., row, col], doc=f"Covariance {name}.")


class ParameterBeam(Beam):
    """Beam described by its first and second moments.

    :param mu: Mean vector of shape ``(..., 7)`` (the 7th entry is 1).
    :param cov: Covariance matrix of shape ``(..., 7, 7)``.
    :param energy: Reference energy of the beam in eV.
    :param total_charge: Total charge of the beam in C.
    :param s: Position along the beamline of the reference particle in m.
    :param species: Particle species of the beam. Defaults to electron.

    Every tensor must lie on the device of ``mu``; a tensor on another
    device raises instead of being moved.
    """

    UNVECTORIZED_NUM_ATTR_DIMS = Beam.UNVECTORIZED_NUM_ATTR_DIMS | {"mu": 1, "cov": 2}

    def __init__(
        self,
        mu: torch.Tensor,
        cov: torch.Tensor,
        energy: torch.Tensor | float,
        total_charge: torch.Tensor | float | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        mu = as_float_tensor(mu, dtype=dtype, device=device)
        dtype, device = mu.dtype, mu.device
        if species is None:
            species = Species("electron", dtype=dtype, device=device)
        elif not same_device(species.mass_eV.device, device):
            raise ValueError(
                f"Species tensors are on {species.mass_eV.device}, mu on {device}."
            )
        self.mu = mu
        self.cov = as_float_tensor(cov, dtype=dtype, device=device)
        self.energy = as_float_tensor(energy, dtype=dtype, device=device)
        self.total_charge = as_float_tensor(
            total_charge if total_charge is not None else 0.0, dtype=dtype, device=device
        )
        self.s = as_float_tensor(s if s is not None else 0.0, dtype=dtype, device=device)
        self.species = species

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_parameters(
        cls,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        s: torch.Tensor | float | None = None,
        species: Species | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        validate: bool = True,
        **moments: torch.Tensor | float | None,
    ) -> "ParameterBeam":
        """Create a beam from named first and second moments (``mu_x``, ...,
        ``sigma_x``, ..., ``cov_xpx``, ..., ``cov_pytau``).

        :param validate: Check that the covariance matrix is positive
            definite (one host synchronisation).
        :raises ValueError: if ``validate`` and the covariance matrix is not
            positive definite.
        """
        dtype, device = infer_dtype_device(
            [energy, total_charge, s, *moments.values()], dtype, device
        )
        params = _moments.resolve_parameters(dtype, device, **moments)
        mu6 = _moments.build_mu(params)
        cov6 = _moments.build_cov(params)
        if validate and bool(torch.any(torch.linalg.cholesky_ex(cov6).info != 0)):
            raise ValueError(
                "The covariance matrix of the beam must be positive definite. "
                "Please check the input parameters to ensure that they are "
                "consistent."
            )
        return cls(
            mu=torch.cat([mu6, torch.ones_like(mu6[..., :1])], dim=-1),
            cov=torch.nn.functional.pad(cov6, (0, 1, 0, 1)),
            energy=energy if energy is not None else 1e8,
            total_charge=total_charge,
            s=s,
            species=species,
            dtype=dtype,
            device=device,
        )

    @classmethod
    def from_twiss(
        cls,
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
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParameterBeam":
        """Create a beam from Twiss parameters.

        :raises ValueError: if a beta function is not positive everywhere.
        """
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
            [value for value, _ in twiss.values()] + [energy, total_charge, s], dtype, device
        )
        t = {
            name: as_float_tensor(
                value if value is not None else default, dtype=dtype, device=device
            )
            for name, (value, default) in twiss.items()
        }
        for plane in ("x", "y"):
            if not bool(torch.all(t[f"beta_{plane}"] > 0)):
                raise ValueError(
                    f"Beta function in {plane} direction must be larger than 0 everywhere."
                )
        moments = _moments.twiss_to_parameters(
            t["beta_x"], t["alpha_x"], t["emittance_x"], t["beta_y"], t["alpha_y"],
            t["emittance_y"], t["sigma_p"], t["dispersion_x"], t["dispersion_px"],
            t["dispersion_y"], t["dispersion_py"],
        )
        return cls.from_parameters(
            sigma_tau=t["sigma_tau"],
            sigma_p=t["sigma_p"],
            cov_taup=t["cov_taup"],
            energy=energy,
            total_charge=total_charge,
            s=s,
            species=species,
            dtype=dtype,
            device=device,
            **moments,
        )

    @classmethod
    def from_astra(
        cls,
        path: str,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParameterBeam":
        """Load an ASTRA particle distribution as its moments.

        :param device: Device of the beam; the GPU when ``None``.
        """
        from cheetah_tpu_torch.converters.astra import from_astrabeam

        particles, energy, particle_charges = from_astrabeam(path)
        return cls._from_host_samples(particles, energy, particle_charges.sum(), dtype, device)

    @classmethod
    def from_ocelot(
        cls,
        parray,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "ParameterBeam":
        """Load an Ocelot ``ParticleArray`` as its moments.

        :param device: Device of the beam; the GPU when ``None``.
        """
        return cls._from_host_samples(
            np.asarray(parray.rparticles).T, 1e9 * parray.E,
            np.sum(np.asarray(parray.q_array)), dtype, device,
        )

    @classmethod
    def _from_host_samples(cls, particles, energy, total_charge, dtype, device):
        """An electron beam with the mean and covariance (numpy's, unbiased)
        of the ``(N, 6)`` samples ``particles``."""
        dtype = dtype if dtype is not None else torch.get_default_dtype()
        device = resolve_device(device)
        mu = torch.ones(7, dtype=dtype, device=device)
        mu[:6] = torch.as_tensor(particles.mean(axis=0), dtype=dtype, device=device)
        cov = torch.zeros((7, 7), dtype=dtype, device=device)
        cov[:6, :6] = torch.as_tensor(np.cov(particles.T), dtype=dtype, device=device)
        return cls(
            mu=mu,
            cov=cov,
            energy=torch.as_tensor(energy, dtype=dtype, device=device),
            total_charge=torch.as_tensor(total_charge, dtype=dtype, device=device),
            species=Species("electron", dtype=dtype, device=device),
        )

    # ------------------------------------------------------------------
    # Transformations
    # ------------------------------------------------------------------

    def transformed_to(
        self,
        energy: torch.Tensor | float | None = None,
        total_charge: torch.Tensor | float | None = None,
        species: Species | None = None,
        **moments: torch.Tensor | float | None,
    ) -> "ParameterBeam":
        """A version of this beam with the given moments replaced and all
        others kept."""
        current = {name: getattr(self, name) for name in _moments.PARAMETER_DEFAULTS}
        current.update({name: value for name, value in moments.items() if value is not None})
        return self.__class__.from_parameters(
            energy=energy if energy is not None else self.energy,
            total_charge=total_charge if total_charge is not None else self.total_charge,
            s=self.s,
            species=species if species is not None else self.species,
            dtype=self.mu.dtype,
            device=self.mu.device,
            **current,
        )

    def as_particle_beam(
        self, num_particles: int, generator: torch.Generator | None = None
    ) -> ParticleBeam:
        """Sample a :class:`ParticleBeam` with exactly this beam's moments.

        :param generator: Random number generator for the sample; the global
            generator of the beam's device when ``None``.
        """
        return ParticleBeam.from_distribution(
            mu=self.mu[..., :6],
            cov=self.cov[..., :6, :6],
            num_particles=num_particles,
            energy=self.energy,
            total_charge=self.total_charge,
            s=self.s,
            species=self.species,
            generator=generator,
        )

    def linspaced(self, num_particles: int) -> ParticleBeam:
        """Evenly spaced :class:`ParticleBeam` spanning +-1 sigma of this
        beam in each dimension."""
        return ParticleBeam.make_linspaced(
            num_particles=num_particles,
            **{f"mu_{c}": getattr(self, f"mu_{c}") for c in _COMPONENTS},
            **{f"sigma_{c}": getattr(self, f"sigma_{c}") for c in _COMPONENTS},
            energy=self.energy,
            total_charge=self.total_charge,
            s=self.s,
            species=self.species,
        )

    def clone(self) -> "ParameterBeam":
        """Copy of the beam with every tensor copied."""
        return self.__class__(
            mu=self.mu.clone(),
            cov=self.cov.clone(),
            energy=self.energy.clone(),
            total_charge=self.total_charge.clone(),
            s=self.s.clone(),
            species=self.species.clone(),
        )

    def to(
        self, device: torch.device | str | None = None, dtype: torch.dtype | None = None
    ) -> "ParameterBeam":
        """Copy of the beam with every tensor on ``device`` and in ``dtype``."""
        return ParameterBeam(
            self.mu.to(device, dtype),
            self.cov.to(device, dtype),
            self.energy.to(device, dtype),
            total_charge=self.total_charge.to(device, dtype),
            s=self.s.to(device, dtype),
            species=self.species.to(device, dtype),
        )

    # ------------------------------------------------------------------
    # Statistics
    # ------------------------------------------------------------------

    @property
    def defining_features(self) -> list[str]:
        """Features that define the beam."""
        return ["mu", "cov", "energy", "total_charge", "s", "species"]

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

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(mu={tuple(self.mu.shape)}, "
            f"energy={self.energy!r}, device={self.mu.device}, "
            f"species={self.species.name!r})"
        )
