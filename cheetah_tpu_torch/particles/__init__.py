"""Beams and particle species."""

from cheetah_tpu_torch.particles.beam import Beam
from cheetah_tpu_torch.particles.particle_beam import ParticleBeam
from cheetah_tpu_torch.particles.species import Species

__all__ = ["Beam", "ParticleBeam", "Species"]
