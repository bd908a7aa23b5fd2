"""ASTRA beam distribution reader (counterpart of
``cheetah_tpu/converters/astra.py``).

Pure-numpy parsing (following the Ocelot-adapted math), returning arrays ready
for :class:`~cheetah_tpu_torch.ParticleBeam` construction.
"""

from __future__ import annotations

import numpy as np

from cheetah_tpu_torch.constants import electron_mass_eV


def from_astrabeam(path: str) -> tuple[np.ndarray, float, np.ndarray]:
    """Read an ASTRA beam distribution file.

    :param path: Path to the ASTRA beam distribution file.
    :return: ``(particles (N, 6), reference energy in eV, charges (N,) in C)``.
    """
    raw = np.loadtxt(path)

    # Keep only particles that were not lost (status flag > 0).
    raw = raw[raw[:, 9] > 0]
    num_particles = raw.shape[0]

    reference_momentum = raw[0, 5]

    xp = raw[:, :6].copy()
    # ASTRA stores the reference particle's z and pz absolutely; zero them so
    # all particles are relative to the reference.
    xp[0, 2] = 0.0
    xp[0, 5] = 0.0

    gamma_ref = np.sqrt((reference_momentum / electron_mass_eV) ** 2 + 1)
    energy = gamma_ref * electron_mass_eV
    beta_ref = np.sqrt(1 - gamma_ref**-2)

    momenta = np.stack(
        [xp[:, 3], xp[:, 4], xp[:, 5] + reference_momentum], axis=1
    )
    gamma = np.sqrt(1 + np.sum(momenta * momenta, axis=1) / electron_mass_eV**2)
    beta = np.sqrt(1 - gamma**-2)

    total_momentum = np.linalg.norm(momenta, 2, axis=1, keepdims=True)
    direction = momenta / total_momentum
    cdt = -xp[:, 2] / (beta * direction[:, 2])

    particles = np.zeros((num_particles, 6))
    particles[:, 0] = xp[:, 0] + beta * direction[:, 0] * cdt
    particles[:, 2] = xp[:, 1] + beta * direction[:, 1] * cdt
    particles[:, 4] = cdt
    particles[:, 1] = xp[:, 3] / reference_momentum
    particles[:, 3] = xp[:, 4] / reference_momentum
    particles[:, 5] = (gamma / gamma_ref - 1) / beta_ref

    charges = np.abs(raw[:, 7]) * 1e-9  # nC -> C

    return particles, energy, charges
