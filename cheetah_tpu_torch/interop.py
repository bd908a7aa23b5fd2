"""Carry lattices and beams across from numpy arrays.

The JAX package's state crosses into the port as numpy arrays: a test (or a
user) turns each JAX element into a dict of numpy arrays and static
configuration, and each beam into its arrays, and these functions build the
port's objects from them. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cheetah_tpu_torch import accelerator
from cheetah_tpu_torch.particles import ParameterBeam, ParticleBeam, Species
from cheetah_tpu_torch.utils.device import resolve_device

#: Element types that :func:`segment_from_numpy` can build: every one.
ELEMENT_TYPES = {
    name: getattr(accelerator, name) for name in accelerator.__all__ if name != "Element"
}


def _element_from_dict(spec: dict[str, Any], device: torch.device):
    spec = dict(spec)
    type_name = spec.pop("type")
    if type_name not in ELEMENT_TYPES:
        raise ValueError(
            f"Unknown element type {type_name!r}; the types are {sorted(ELEMENT_TYPES)}."
        )
    if type_name == "Segment":
        return accelerator.Segment(
            [_element_from_dict(child, device) for child in spec.pop("elements")],
            sanitize_name=False,
            **spec,
        )
    kwargs = {}
    for key, value in spec.items():
        if isinstance(value, np.ndarray):
            value = torch.tensor(value, device=device)
        elif isinstance(value, dict) and "type" in value:
            # An element that is a feature of this one (Superimposed's two).
            value = _element_from_dict(value, device)
        kwargs[key] = value
    return ELEMENT_TYPES[type_name](sanitize_name=False, device=device, **kwargs)


def segment_from_numpy(
    elements: list[dict[str, Any]],
    name: str | None = None,
    device: torch.device | str | None = None,
) -> accelerator.Segment:
    """Build a :class:`Segment` from element descriptions.

    :param elements: One dict per element: ``"type"`` (the class name),
        ``"name"``, a numpy array for every physical field (``length``,
        ``k1``, ``misalignment``, ...) and the static configuration
        (``tracking_method``, ``grid_shape``, ``resolution``, ``method``,
        ``is_active``, ...), all under the
        constructor's keyword names. A ``"Segment"`` holds its children
        under ``"elements"``; an element-valued feature
        (``Superimposed.base_element``) is such a dict itself.
    :param device: Device of the lattice; the GPU when ``None``. The arrays
        keep their dtypes.
    """
    device = resolve_device(device)
    return accelerator.Segment(
        [_element_from_dict(spec, device) for spec in elements],
        name=name,
        sanitize_name=False,
    )


def _tensors_like(first: np.ndarray, device: torch.device | str | None):
    """``first`` as a tensor on ``device`` (the GPU when ``None``), and a
    function turning further arrays into tensors of its dtype there."""
    device = resolve_device(device)
    tensor = torch.tensor(np.asarray(first), device=device)

    def convert(array: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(array), dtype=tensor.dtype, device=device)

    return tensor, convert


def particle_beam_from_numpy(
    particles: np.ndarray,
    energy: np.ndarray,
    particle_charges: np.ndarray,
    survival_probabilities: np.ndarray,
    species_name: str = "electron",
    device: torch.device | str | None = None,
) -> ParticleBeam:
    """Build a :class:`ParticleBeam` from its arrays; the dtype is that of
    ``particles``.

    :param species_name: A species of ``Species.known``.
    :param device: Device of the beam; the GPU when ``None``.
    """
    tensor, convert = _tensors_like(particles, device)
    return ParticleBeam(
        tensor,
        convert(energy),
        particle_charges=convert(particle_charges),
        survival_probabilities=convert(survival_probabilities),
        species=Species(species_name, dtype=tensor.dtype, device=tensor.device),
    )


def parameter_beam_from_numpy(
    mu: np.ndarray,
    cov: np.ndarray,
    energy: np.ndarray,
    total_charge: np.ndarray,
    s: np.ndarray | None = None,
    species_name: str = "electron",
    device: torch.device | str | None = None,
) -> ParameterBeam:
    """Build a :class:`ParameterBeam` from its arrays; the dtype is that of
    ``mu``.

    :param species_name: A species of ``Species.known``.
    :param device: Device of the beam; the GPU when ``None``.
    """
    tensor, convert = _tensors_like(mu, device)
    return ParameterBeam(
        tensor,
        convert(cov),
        convert(energy),
        total_charge=convert(total_charge),
        s=convert(s) if s is not None else None,
        species=Species(species_name, dtype=tensor.dtype, device=tensor.device),
    )
