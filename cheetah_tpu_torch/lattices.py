"""Built-in example lattices (counterpart of ``cheetah_tpu/lattices.py``).

The ARES Experimental Area (EA) subcell is the section from AREASOLA1 to
AREABSCR1 of the ARES accelerator at DESY: drifts, three quadrupoles and two
corrector coils, ending at the AREABSCR1 screen. ``ares_stage3`` is the
whole ARES linear accelerator, read from the package's own LatticeJSON.
``cold_beam_line`` is a space-charge transport line that the structure
operations build: the cold uniform beam of ImpactX's expanding-beam
benchmark and the drift it doubles its size in, cut by ``split`` and
interleaved with space-charge kicks.
"""

from __future__ import annotations

import math
import pathlib

import torch

from cheetah_tpu_torch import constants
from cheetah_tpu_torch.accelerator import (
    Drift,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Screen,
    Segment,
    SpaceChargeKick,
    VerticalCorrector,
)
from cheetah_tpu_torch.particles import ParticleBeam


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


def cold_beam_line(
    kicks: int = 10,
    grid_shape: tuple[int, int, int] = (32, 32, 32),
    num_particles: int = 1_000_000,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> tuple[ParticleBeam, Segment]:
    """A cold uniform beam and the space-charge line it doubles its size in
    (ImpactX's expanding-beam benchmark, the JAX package's
    ``tests/test_space_charge.py:53-104``): a 1 mm sphere (in the beam frame)
    of 10 nC at 250 MeV with momentum spreads of 1e-15, and a drift of the
    analytic doubling length L built as a user builds such a line:
    ``Drift(L).split`` into ``2 * kicks`` pieces, a ``SpaceChargeKick(L /
    kicks)`` after every second piece, the drifts left side by side merged
    by ``with_consecutive_elements_merged``. The line is ``D(L / 2k) K D(L /
    k) K ... K D(L / 2k)``, ``2 * kicks + 1`` plan entries.

    :param kicks: Number of space-charge kicks.
    :param grid_shape: The kicks' grid.
    :param generator: Random number generator for the beam.
    :return: ``(beam, line)``.
    """
    radius, energy = 1e-3, 2.5e8
    gamma = energy / constants.electron_mass_eV
    beta = math.sqrt(1.0 - 1.0 / gamma**2)
    beam = ParticleBeam.uniform_3d_ellipsoid(
        num_particles=num_particles, radius_x=radius, radius_y=radius,
        radius_tau=radius / (gamma * beta), sigma_px=1e-15, sigma_py=1e-15, sigma_p=1e-15,
        energy=energy, total_charge=1e-8, generator=generator, dtype=dtype, device=device,
    )
    kappa = 1.0 + math.sqrt(2.0) / 4.0 * math.log(3.0 + 2.0 * math.sqrt(2.0))
    electrons = 1e-8 / constants.elementary_charge
    length = beta * gamma * kappa * math.sqrt(radius**3 / (electrons * constants.electron_radius))
    kw = {"dtype": dtype, "device": beam.particles.device}
    # A hair over L / 2k, so that rounding cannot make one piece more.
    pieces = Drift(length, name="drift", **kw).split(length / (2 * kicks) * (1.0 + 1e-6))
    elements = []
    for index, piece in enumerate(pieces):
        elements.append(piece)
        if index % 2 == 0:
            elements.append(
                SpaceChargeKick(length / kicks, grid_shape=grid_shape, name=f"kick_{index // 2}", **kw)
            )
    line = Segment(elements, name="space_charge_line").with_consecutive_elements_merged()
    return beam, line
