"""Lattice and beam converters of the port (counterpart of
``cheetah_tpu/converters``): Elegant, Bmad, NX Tables and Ocelot lattices,
ASTRA, Elegant SDDS and openPMD beams. Every converter builds on the GPU
unless the caller passes ``device="cpu"``."""

from cheetah_tpu_torch.converters import astra, bmad, elegant, nxtables, ocelot
from cheetah_tpu_torch.converters.expressions import evaluate_infix, evaluate_rpn

__all__ = [
    "astra",
    "bmad",
    "elegant",
    "evaluate_infix",
    "evaluate_rpn",
    "nxtables",
    "ocelot",
]
