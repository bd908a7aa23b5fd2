"""Physical aperture (counterpart of ``cheetah_tpu/accelerator/aperture.py``)."""

from __future__ import annotations

import warnings

import torch

from cheetah_tpu_torch.accelerator.element import (
    Element,
    ZeroLengthMixin,
    identity_transfer_map,
)
from cheetah_tpu_torch.particles import Beam, ParticleBeam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.warnings import PhysicsWarning

SHAPES = ("rectangular", "elliptical")


class Aperture(ZeroLengthMixin, Element):
    """Physical aperture that removes particles outside its opening.

    Particles are not deleted (that would change the tensors' shapes):
    each particle's ``survival_probability`` is multiplied by an inside
    mask, and positions are untouched. Only a ``ParticleBeam`` is affected,
    and only while the aperture is active; a ``ParameterBeam`` passes
    through with a :class:`PhysicsWarning`.

    :param x_max: Horizontal half-opening in m.
    :param y_max: Vertical half-opening in m.
    :param shape: ``"rectangular"`` or ``"elliptical"``.
    :param is_active: Whether the aperture blocks particles.
    :param name: Unique identifier of the element.
    :param device: Device for openings given as Python numbers; the GPU
        when ``None``.
    """

    def __init__(
        self,
        x_max: torch.Tensor | float | None = None,
        y_max: torch.Tensor | float | None = None,
        shape: str = "rectangular",
        is_active: bool = True,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        if shape not in SHAPES:
            raise ValueError(f"Unknown aperture shape {shape}")
        super().__init__()
        self._register_parameters(
            ("x_max", x_max if x_max is not None else float("inf")),
            dtype,
            device,
            y_max=y_max if y_max is not None else float("inf"),
        )
        self.shape = shape
        self.is_active = is_active
        self._init_element(name, sanitize_name, metadata)

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return identity_transfer_map(energy)

    def _track(self, incoming: Beam) -> Beam:
        if not self.is_active:
            return incoming
        if not isinstance(incoming, ParticleBeam):
            warnings.warn(
                "Aperture tracking is currently only supported for `ParticleBeam`.",
                PhysicsWarning,
                stacklevel=2,
            )
            return incoming

        x_max, y_max = self.x_max[..., None], self.y_max[..., None]
        if self.shape == "rectangular":
            survived = (
                (incoming.x > -x_max)
                & (incoming.x < x_max)
                & (incoming.y > -y_max)
                & (incoming.y < y_max)
            )
        else:
            survived = (
                torch.square(incoming.x) / torch.square(x_max)
                + torch.square(incoming.y) / torch.square(y_max)
            ) <= 1.0
        return ParticleBeam(
            incoming.particles,
            incoming.energy,
            particle_charges=incoming.particle_charges,
            survival_probabilities=incoming.survival_probabilities * survived,
            s=incoming.s,
            species=incoming.species,
        )

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["x_max", "y_max", "shape", "is_active"]
