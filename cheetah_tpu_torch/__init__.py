"""cheetah_tpu_torch: the PyTorch and CUDA port of cheetah_tpu.

It keeps the JAX package's module layout and runs on the GPU unless the
caller passes ``device="cpu"``. The cloud-in-cell deposit and gather of the
space-charge kick are CUDA kernels written for Hopper (``csrc/cic.cu``),
built with nvcc at first use. The screens' readouts (histogram,
cloud-in-cell, KDE) and the moment tracking of ``ParameterBeam`` are plain
PyTorch, as they are XLA in the JAX package, and so are the nonlinear
elements (Cavity, Dipole, RBend, Sextupole, the transverse deflecting
cavity; second-order T-tensors and Bmad-X drift-kick-drift tracking), the
remaining linear elements (Solenoid, Undulator, CombinedCorrector,
CustomTransferMap, Superimposed) and the LatticeJSON format that loads
the whole ARES linear accelerator (``lattices.ares_stage3``). Every autograd
Function of the package works under ``torch.func`` (``grad``, ``jvp``,
``jacfwd``, ``hessian``, ``vmap``). The structure operations edit a lattice
(``Segment.subcell``, ``split``, ``merge``, ``clone``, the lattice passes,
``explain_plan``), and ``Segment.track_checkpointed`` recomputes each plan
entry during backward instead of keeping its intermediates. Lattices import
from Elegant, Bmad, NX Tables and Ocelot (``Segment.from_*``, the
``converters`` package), beams from ASTRA, Elegant SDDS and openPMD files;
``plotting`` draws lattices and beams, ``utils.aot`` exports a tracking
step with ``torch.export`` and ``utils.profiling`` times and counts it.
"""

from cheetah_tpu_torch import latticejson, lattices
from cheetah_tpu_torch.accelerator import (
    BPM,
    Aperture,
    Cavity,
    CombinedCorrector,
    CustomTransferMap,
    Dipole,
    Drift,
    Element,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    RBend,
    Screen,
    Segment,
    Sextupole,
    Solenoid,
    SpaceChargeKick,
    Superimposed,
    TransverseDeflectingCavity,
    Undulator,
    VerticalCorrector,
)
from cheetah_tpu_torch import converters
from cheetah_tpu_torch.ops import transfer_maps as track_methods
from cheetah_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam, Species
from cheetah_tpu_torch.utils.warnings import (
    DefaultParameterWarning,
    DirtyNameWarning,
    NoBeamPropertiesInLatticeWarning,
    NotUnderstoodPropertyWarning,
    PhysicsWarning,
    UnknownElementWarning,
    VisualizationWarning,
)

__all__ = [
    "Aperture",
    "BPM",
    "Beam",
    "DefaultParameterWarning",
    "DirtyNameWarning",
    "NoBeamPropertiesInLatticeWarning",
    "NotUnderstoodPropertyWarning",
    "PhysicsWarning",
    "UnknownElementWarning",
    "VisualizationWarning",
    "Cavity",
    "CombinedCorrector",
    "CustomTransferMap",
    "Dipole",
    "Drift",
    "Element",
    "HorizontalCorrector",
    "Marker",
    "ParameterBeam",
    "ParticleBeam",
    "Quadrupole",
    "RBend",
    "Screen",
    "Segment",
    "Sextupole",
    "Solenoid",
    "SpaceChargeKick",
    "Species",
    "Superimposed",
    "TransverseDeflectingCavity",
    "Undulator",
    "VerticalCorrector",
    "converters",
    "latticejson",
    "lattices",
    "track_methods",
]
