"""Accelerator elements and the ``Segment`` container."""

from cheetah_tpu_torch.accelerator.correctors import HorizontalCorrector, VerticalCorrector
from cheetah_tpu_torch.accelerator.drift import Drift
from cheetah_tpu_torch.accelerator.element import Element
from cheetah_tpu_torch.accelerator.marker import Marker
from cheetah_tpu_torch.accelerator.quadrupole import Quadrupole
from cheetah_tpu_torch.accelerator.segment import Segment
from cheetah_tpu_torch.accelerator.space_charge_kick import SpaceChargeKick

__all__ = [
    "Drift",
    "Element",
    "HorizontalCorrector",
    "Marker",
    "Quadrupole",
    "Segment",
    "SpaceChargeKick",
    "VerticalCorrector",
]
