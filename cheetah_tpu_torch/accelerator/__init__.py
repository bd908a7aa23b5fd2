"""Accelerator elements and the ``Segment`` container."""

from cheetah_tpu_torch.accelerator.aperture import Aperture
from cheetah_tpu_torch.accelerator.bpm import BPM
from cheetah_tpu_torch.accelerator.cavity import Cavity
from cheetah_tpu_torch.accelerator.correctors import (
    CombinedCorrector,
    HorizontalCorrector,
    VerticalCorrector,
)
from cheetah_tpu_torch.accelerator.custom_transfer_map import CustomTransferMap
from cheetah_tpu_torch.accelerator.dipole import Dipole
from cheetah_tpu_torch.accelerator.drift import Drift
from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.accelerator.marker import Marker
from cheetah_tpu_torch.accelerator.quadrupole import Quadrupole
from cheetah_tpu_torch.accelerator.rbend import RBend
from cheetah_tpu_torch.accelerator.screen import Screen
from cheetah_tpu_torch.accelerator.segment import Segment
from cheetah_tpu_torch.accelerator.sextupole import Sextupole
from cheetah_tpu_torch.accelerator.solenoid import Solenoid
from cheetah_tpu_torch.accelerator.space_charge_kick import SpaceChargeKick
from cheetah_tpu_torch.accelerator.superimposed import Superimposed
from cheetah_tpu_torch.accelerator.transverse_deflecting_cavity import (
    TransverseDeflectingCavity,
)
from cheetah_tpu_torch.accelerator.undulator import Undulator

__all__ = [
    "Aperture",
    "BPM",
    "Cavity",
    "CombinedCorrector",
    "CustomTransferMap",
    "Dipole",
    "Drift",
    "Element",
    "HorizontalCorrector",
    "Marker",
    "Quadrupole",
    "RBend",
    "Screen",
    "Segment",
    "Sextupole",
    "Solenoid",
    "SpaceChargeKick",
    "Superimposed",
    "TransverseDeflectingCavity",
    "Undulator",
    "VerticalCorrector",
]
