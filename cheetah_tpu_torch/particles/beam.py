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
    """Abstract beam interface. Use :class:`ParticleBeam`."""

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
