"""Built-in example lattices (counterpart of ``cheetah_tpu/lattices.py``).

The ARES Experimental Area (EA) subcell is the section from AREASOLA1 to
AREABSCR1 of the ARES accelerator at DESY: drifts, three quadrupoles and two
corrector coils, ending at the AREABSCR1 screen. ``ares_stage3`` is the
whole ARES linear accelerator, read from the package's own LatticeJSON.
"""

from __future__ import annotations

import pathlib

import torch

from cheetah_tpu_torch.accelerator import (
    Drift,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Screen,
    Segment,
    VerticalCorrector,
)


def ares_ea_subcell(
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    screen: bool = False,
) -> Segment:
    """ARES EA quadrupole-triplet subcell (AREASOLA1 -> AREABSCR1), 13
    elements.

    :param device: Device of the lattice parameters; the GPU when ``None``.
    :param screen: End in the active AREABSCR1 screen (2448 x 2040 pixels
        of 3.3198 x 2.4469 um, binning 1, cloud-in-cell) instead of a
        marker.
    """
    kw = {"dtype": dtype, "device": device}
    elements = [
        Marker(name="AREASOLA1", **kw),
        Drift(0.17504, name="Drift_AREASOLA1", **kw),
        Quadrupole(0.122, k1=10.0, name="AREAMQZM1", **kw),
        Drift(0.428, name="Drift_AREAMQZM1", **kw),
        Quadrupole(0.122, k1=-9.0, name="AREAMQZM2", **kw),
        Drift(0.204, name="Drift_AREAMQZM2", **kw),
        VerticalCorrector(0.02, angle=1e-4, name="AREAMCVM1", **kw),
        Drift(0.204, name="Drift_AREAMCVM1", **kw),
        Quadrupole(0.122, k1=-8.0, name="AREAMQZM3", **kw),
        Drift(0.179, name="Drift_AREAMQZM3", **kw),
        HorizontalCorrector(0.02, angle=-1e-4, name="AREAMCHM1", **kw),
        Drift(0.45, name="Drift_AREAMCHM1", **kw),
        (
            Screen(
                resolution=(2448, 2040),
                pixel_size=(3.3198e-6, 2.4469e-6),
                binning=1,
                is_active=True,
                name="AREABSCR1",
                **kw,
            )
            if screen
            else Marker(name="AREABSCR1", **kw)
        ),
    ]
    return Segment(elements, name="ARES_EA")


def ares_stage3(
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Segment:
    """The complete 195-element ARES linear accelerator (stage 3) at DESY,
    from ``resources/ares_stage3.json`` (converted from the public
    ``ARESlatticeStage3v1_9`` Ocelot description). Its magnets are at zero
    strength, its 14 screens and 8 BPMs inactive, and its 3 apertures
    active with infinite openings.

    :param device: Device of the lattice parameters; the GPU when ``None``.
    """
    path = pathlib.Path(__file__).parent / "resources" / "ares_stage3.json"
    return Segment.from_lattice_json(str(path), dtype=dtype, device=device)
