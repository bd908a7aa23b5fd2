"""cheetah_tpu_torch: the PyTorch and CUDA port of cheetah_tpu.

It keeps the JAX package's module layout and runs on the GPU unless the
caller passes ``device="cpu"``. The cloud-in-cell deposit and gather of the
space-charge kick are CUDA kernels written for Hopper (``csrc/cic.cu``),
built with nvcc at first use.
"""

from cheetah_tpu_torch import lattices
from cheetah_tpu_torch.accelerator import (
    Drift,
    Element,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Segment,
    SpaceChargeKick,
    VerticalCorrector,
)
from cheetah_tpu_torch.particles import Beam, ParticleBeam, Species

__all__ = [
    "Beam",
    "Drift",
    "Element",
    "HorizontalCorrector",
    "Marker",
    "ParticleBeam",
    "Quadrupole",
    "Segment",
    "SpaceChargeKick",
    "Species",
    "VerticalCorrector",
    "lattices",
]
