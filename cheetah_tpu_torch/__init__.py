"""cheetah_tpu_torch: the PyTorch and CUDA port of cheetah_tpu.

It keeps the JAX package's module layout and runs on the GPU unless the
caller passes ``device="cpu"``. The cloud-in-cell deposit and gather of the
space-charge kick are CUDA kernels written for Hopper (``csrc/cic.cu``),
built with nvcc at first use. The screens' readouts (histogram,
cloud-in-cell, KDE) and the moment tracking of ``ParameterBeam`` are plain
PyTorch, as they are XLA in the JAX package.
"""

from cheetah_tpu_torch import lattices
from cheetah_tpu_torch.accelerator import (
    BPM,
    Aperture,
    Drift,
    Element,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Screen,
    Segment,
    SpaceChargeKick,
    VerticalCorrector,
)
from cheetah_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam, Species

__all__ = [
    "Aperture",
    "BPM",
    "Beam",
    "Drift",
    "Element",
    "HorizontalCorrector",
    "Marker",
    "ParameterBeam",
    "ParticleBeam",
    "Quadrupole",
    "Screen",
    "Segment",
    "SpaceChargeKick",
    "Species",
    "VerticalCorrector",
    "lattices",
]
