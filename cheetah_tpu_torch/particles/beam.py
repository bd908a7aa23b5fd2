r"""Beam base class (counterpart of ``cheetah_tpu/particles/beam.py``).

Each particle state is ``(x, px, y, py, tau, p, 1)``: transverse positions
in m, transverse momenta normalised to the reference momentum, the
longitudinal position relative to the reference particle in m, the relative
energy deviation, and the constant 1 that makes thin kicks and
misalignments affine.
"""

from __future__ import annotations

import torch


class Beam:
    """Abstract beam interface. Use :class:`ParticleBeam` or
    :class:`ParameterBeam`. Subclasses provide the first and second moments
    (``mu_*``, ``sigma_*``, ``cov_*``); this base derives emittances, Twiss
    functions and dispersion from them."""

    #: Number of trailing non-vector dimensions of multi-dimensional
    #: attributes, for stacking them along a lattice.
    UNVECTORIZED_NUM_ATTR_DIMS: dict[str, int] = {}

    @property
    def relativistic_gamma(self) -> torch.Tensor:
        """Reference relativistic gamma of the beam."""
        return self.energy / self.species.mass_eV

    @property
    def relativistic_beta(self) -> torch.Tensor:
        """Reference relativistic beta; 1 where gamma is 0."""
        gamma = self.relativistic_gamma
        nonzero = torch.abs(gamma) > 0
        safe_gamma = torch.where(nonzero, gamma, torch.ones_like(gamma))
        return torch.where(
            nonzero,
            torch.sqrt(1.0 - 1.0 / torch.square(safe_gamma)),
            torch.ones_like(gamma),
        )

    @property
    def p0c(self) -> torch.Tensor:
        """Reference momentum times speed of light in eV."""
        return self.relativistic_beta * self.relativistic_gamma * self.species.mass_eV

    def _emittance(
        self,
        sigma_position: torch.Tensor,
        sigma_momentum: torch.Tensor,
        cov_position_momentum: torch.Tensor,
        cov_position_p: torch.Tensor,
        cov_momentum_p: torch.Tensor,
    ) -> torch.Tensor:
        """Dispersion-corrected betatron emittance of one plane; clamped at
        the dtype's ``tiny`` so that it is never NaN or 0."""
        sigma_p2 = torch.square(self.sigma_p)
        term = (torch.square(sigma_position) - torch.square(cov_position_p) / sigma_p2) * (
            torch.square(sigma_momentum) - torch.square(cov_momentum_p) / sigma_p2
        ) - torch.square(cov_position_momentum - cov_position_p * cov_momentum_p / sigma_p2)
        return torch.sqrt(torch.clamp(term, min=torch.finfo(term.dtype).tiny))

    @property
    def projected_emittance_x(self) -> torch.Tensor:
        """Projected emittance in x in m (no dispersion correction)."""
        return torch.sqrt(
            torch.square(self.sigma_x) * torch.square(self.sigma_px)
            - torch.square(self.cov_xpx)
        )

    @property
    def emittance_x(self) -> torch.Tensor:
        """Dispersion-corrected betatron emittance in x in m."""
        return self._emittance(
            self.sigma_x, self.sigma_px, self.cov_xpx, self.cov_xp, self.cov_pxp
        )

    @property
    def normalized_emittance_x(self) -> torch.Tensor:
        """Normalized emittance in x in m."""
        return self.emittance_x * self.relativistic_beta * self.relativistic_gamma

    @property
    def beta_x(self) -> torch.Tensor:
        """Beta function in x in m."""
        return (
            torch.square(self.sigma_x) - torch.square(self.cov_xp) / torch.square(self.sigma_p)
        ) / self.emittance_x

    @property
    def alpha_x(self) -> torch.Tensor:
        """Alpha function in x (dimensionless)."""
        return (
            -(self.cov_xpx - self.cov_xp * self.cov_pxp / torch.square(self.sigma_p))
            / self.emittance_x
        )

    @property
    def projected_emittance_y(self) -> torch.Tensor:
        """Projected emittance in y in m (no dispersion correction)."""
        return torch.sqrt(
            torch.square(self.sigma_y) * torch.square(self.sigma_py)
            - torch.square(self.cov_ypy)
        )

    @property
    def emittance_y(self) -> torch.Tensor:
        """Dispersion-corrected betatron emittance in y in m."""
        return self._emittance(
            self.sigma_y, self.sigma_py, self.cov_ypy, self.cov_yp, self.cov_pyp
        )

    @property
    def normalized_emittance_y(self) -> torch.Tensor:
        """Normalized emittance in y in m."""
        return self.emittance_y * self.relativistic_beta * self.relativistic_gamma

    @property
    def beta_y(self) -> torch.Tensor:
        """Beta function in y in m."""
        return (
            torch.square(self.sigma_y) - torch.square(self.cov_yp) / torch.square(self.sigma_p)
        ) / self.emittance_y

    @property
    def alpha_y(self) -> torch.Tensor:
        """Alpha function in y (dimensionless)."""
        return (
            -(self.cov_ypy - self.cov_yp * self.cov_pyp / torch.square(self.sigma_p))
            / self.emittance_y
        )

    @property
    def dispersion_x(self) -> torch.Tensor:
        """Dispersion in x in m."""
        return self.cov_xp / torch.square(self.sigma_p)

    @property
    def dispersion_px(self) -> torch.Tensor:
        """Dispersion in px (dimensionless)."""
        return self.cov_pxp / torch.square(self.sigma_p)

    @property
    def dispersion_y(self) -> torch.Tensor:
        """Dispersion in y in m."""
        return self.cov_yp / torch.square(self.sigma_p)

    @property
    def dispersion_py(self) -> torch.Tensor:
        """Dispersion in py (dimensionless)."""
        return self.cov_pyp / torch.square(self.sigma_p)
