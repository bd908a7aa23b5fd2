"""Physical constants used throughout the framework.

Values are taken from ``scipy.constants`` (CODATA), matching the reference
implementation's constant sources (``cheetah/particles/species.py:5-9``).
"""

from scipy.constants import physical_constants

#: Electron rest mass energy equivalent in eV.
electron_mass_eV: float = (
    physical_constants["electron mass energy equivalent in MeV"][0] * 1e6
)

#: Proton rest mass energy equivalent in eV.
proton_mass_eV: float = (
    physical_constants["proton mass energy equivalent in MeV"][0] * 1e6
)

#: Deuteron rest mass energy equivalent in eV.
deuteron_mass_eV: float = (
    physical_constants["deuteron mass energy equivalent in MeV"][0] * 1e6
)

#: Elementary charge in C.
elementary_charge: float = physical_constants["elementary charge"][0]

#: Conversion factor eV -> kg (E = m c^2).
eV_to_kg: float = physical_constants["electron volt-kilogram relationship"][0]

#: Speed of light in vacuum in m/s.
speed_of_light: float = physical_constants["speed of light in vacuum"][0]

#: Vacuum electric permittivity in F/m.
epsilon_0: float = physical_constants["vacuum electric permittivity"][0]

#: Classical electron radius in m.
electron_radius: float = physical_constants["classical electron radius"][0]
