"""Particle species (counterpart of ``cheetah_tpu/particles/species.py``).

The name is plain configuration; charge and mass are tensors on the
species' device, so they combine with beam tensors without a transfer.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch import constants
from cheetah_tpu_torch.utils.device import as_float_tensor, infer_dtype_device


class Species:
    """Named particle species defined by charge and mass.

    :param name: Name of the particle species. For species in ``Species.known``,
        charge and mass are populated automatically. Custom species (e.g. ions)
        need charge and mass.
    :param num_elementary_charges: Charge in units of elementary charge e.
    :param charge_coulomb: Charge in Coulombs (alternative to
        ``num_elementary_charges``).
    :param mass_eV: Mass in eV (alternative to ``mass_kg``).
    :param mass_kg: Mass in kg.
    :param device: Device of the charge and mass tensors; ``"cuda"`` when
        ``None`` and no tensor is given.
    """

    known = {
        "electron": {"num_elementary_charges": -1, "mass_eV": constants.electron_mass_eV},
        "positron": {"num_elementary_charges": 1, "mass_eV": constants.electron_mass_eV},
        "proton": {"num_elementary_charges": 1, "mass_eV": constants.proton_mass_eV},
        "antiproton": {"num_elementary_charges": -1, "mass_eV": constants.proton_mass_eV},
        "deuteron": {"num_elementary_charges": 1, "mass_eV": constants.deuteron_mass_eV},
    }

    def __init__(
        self,
        name: str,
        num_elementary_charges: torch.Tensor | float | None = None,
        charge_coulomb: torch.Tensor | float | None = None,
        mass_eV: torch.Tensor | float | None = None,
        mass_kg: torch.Tensor | float | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        given = (num_elementary_charges, charge_coulomb, mass_eV, mass_kg)
        if name in self.known:
            if any(value is not None for value in given):
                raise ValueError(
                    "Known particle species should not have charge and mass provided."
                )
            num_elementary_charges = self.known[name]["num_elementary_charges"]
            mass_eV = self.known[name]["mass_eV"]
        else:
            if (num_elementary_charges is None and charge_coulomb is None) or (
                mass_eV is None and mass_kg is None
            ):
                raise ValueError(
                    "Custom particle species should have charge and mass provided."
                )
            if num_elementary_charges is not None and charge_coulomb is not None:
                raise ValueError(
                    "Only one of num_elementary_charges and charge_coulomb should "
                    "be provided."
                )
            if mass_eV is not None and mass_kg is not None:
                raise ValueError("Only one of mass_eV and mass_kg should be provided.")
            if num_elementary_charges is None:
                num_elementary_charges = charge_coulomb / constants.elementary_charge
            if mass_eV is None:
                mass_eV = mass_kg / constants.eV_to_kg

        dtype, device = infer_dtype_device(given, dtype, device)
        self.name = name
        self.num_elementary_charges = as_float_tensor(
            num_elementary_charges, dtype=dtype, device=device
        )
        self.mass_eV = as_float_tensor(mass_eV, dtype=dtype, device=device)

    @property
    def mass_kg(self) -> torch.Tensor:
        """Mass of the particle species in kg."""
        return self.mass_eV * constants.eV_to_kg

    @property
    def charge_coulomb(self) -> torch.Tensor:
        """Charge of the particle species in Coulombs."""
        return self.num_elementary_charges * constants.elementary_charge

    def to(
        self, device: torch.device | str | None = None, dtype: torch.dtype | None = None
    ) -> "Species":
        """Copy of the species with its tensors on ``device`` and in ``dtype``."""
        species = Species.__new__(Species)
        species.name = self.name
        species.num_elementary_charges = self.num_elementary_charges.to(device, dtype)
        species.mass_eV = self.mass_eV.to(device, dtype)
        return species

    def clone(self) -> "Species":
        """Copy of the species with its tensors copied."""
        species = self.to()
        species.num_elementary_charges = species.num_elementary_charges.clone()
        species.mass_eV = species.mass_eV.clone()
        return species

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Species)
            and self.name == other.name
            and bool(torch.all(self.num_elementary_charges == other.num_elementary_charges))
            and bool(torch.all(self.mass_eV == other.mass_eV))
        )

    __hash__ = None
