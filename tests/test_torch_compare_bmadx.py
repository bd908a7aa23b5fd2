"""The port's drift-kick-drift tracking against the stored Bmad/Tao ground
truth for six particle species: the cases of ``tests/test_compare_bmadx.py``
in torch's terms, with its tolerance (atol 1e-13, rtol 1e-5). The expected
outputs come from Bmad itself, not from either package."""

import pathlib

import pytest
import torch

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.utils.bmadx import bmad_to_cheetah_z_pz, cheetah_to_bmad_coords

BMAD_RESOURCES = pathlib.Path(__file__).parent / "resources" / "bmad"
ATOMIC_MASS_EV = 931494103.72  # CODATA atomic mass constant in eV
F64 = {"dtype": torch.float64, "device": "cpu"}


def make_species(name):
    if name == "#12C+3":
        return ctt.Species("#12C+3", num_elementary_charges=3.0,
                           mass_eV=12.0 * ATOMIC_MASS_EV, **F64)
    return ctt.Species(name, **F64)


SPECIES_NAMES = ["proton", "electron", "positron", "antiproton", "deuteron", "#12C+3"]

ELEMENTS = {
    "Drift": lambda: ctt.Drift(length=1.0, tracking_method="drift_kick_drift", **F64),
    "Dipole": lambda: ctt.Dipole(
        length=0.5, angle=0.2, dipole_e1=0.1, dipole_e2=0.1, tilt=0.1, fringe_integral=0.5,
        fringe_integral_exit=0.5, gap=0.06, gap_exit=0.06, fringe_at="both",
        fringe_type="linear_edge", tracking_method="drift_kick_drift", **F64,
    ),
    "Quadrupole": lambda: ctt.Quadrupole(
        length=0.5, k1=1.0, tracking_method="drift_kick_drift", **F64
    ),
}


@pytest.mark.parametrize("species_name", SPECIES_NAMES)
@pytest.mark.parametrize("element_name", ELEMENTS.keys())
def test_against_bmad_tao_ground_truth(species_name, element_name):
    species = make_species(species_name)
    element = ELEMENTS[element_name]()

    coordinates = torch.tensor([1e-3, 2e-3, -3e-3, -1e-3, 2e-3, -1e-3], **F64)
    p0c = torch.tensor(5.0e7, **F64)
    tau, delta, ref_energy = bmad_to_cheetah_z_pz(
        coordinates[4][None], coordinates[5][None], p0c, species.mass_eV
    )
    cheetah_coordinates = torch.cat(
        [coordinates[:4], tau.reshape(1), delta.reshape(1), torch.ones(1, **F64)]
    )[None, :]

    incoming = ctt.ParticleBeam(particles=cheetah_coordinates, energy=ref_energy,
                                species=species)
    outgoing = element.track(incoming)
    outgoing_bmad, _ = cheetah_to_bmad_coords(
        outgoing.particles, ref_energy=outgoing.energy, mc2=outgoing.species.mass_eV
    )

    expected = torch.load(
        BMAD_RESOURCES / f"x_tao_{species_name}_{element_name}.pt", weights_only=True
    )
    torch.testing.assert_close(
        outgoing_bmad.reshape(-1), expected.reshape(-1).to(torch.float64), atol=1e-13, rtol=1e-5
    )
