"""Built-in example lattices (counterpart of ``cheetah_tpu/lattices.py``).

The ARES Experimental Area (EA) subcell is the section from AREASOLA1 to
AREABSCR1 of the ARES accelerator at DESY: drifts, three quadrupoles and two
corrector coils.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator import (
    Drift,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Segment,
    VerticalCorrector,
)


def ares_ea_subcell(
    dtype: torch.dtype = torch.float32, device: torch.device | str | None = None
) -> Segment:
    """ARES EA quadrupole-triplet subcell (AREASOLA1 -> AREABSCR1), 13
    elements, ending in a marker where the JAX package can place its screen.

    :param device: Device of the lattice parameters; the GPU when ``None``.
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
        Marker(name="AREABSCR1", **kw),
    ]
    return Segment(elements, name="ARES_EA")
