"""Element base class (counterpart of ``cheetah_tpu/accelerator/element.py``).

Elements are ``nn.Module``s. Physical parameters (length, k1, misalignment,
...) are registered buffers, not ``nn.Parameter``s: assigning a new tensor
(``segment.AREAMQZM1.k1 = torch.linspace(-20, 20, 4096)``) replaces the
buffer, and ``.to(device)`` moves them all. Configuration (name, tracking
method, grid shapes) is plain Python attributes.

Tracking checks that every buffer lies on the beam's device and raises
otherwise: nothing moves between devices silently.
"""

from __future__ import annotations

import warnings
from typing import Any

import torch
from torch import nn

from cheetah_tpu_torch.particles import Beam, ParticleBeam, Species
from cheetah_tpu_torch.utils.device import as_float_tensor, check_module_device
from cheetah_tpu_torch.utils.names import UniqueNameGenerator
from cheetah_tpu_torch.utils.names import sanitize_name as _sanitize
from cheetah_tpu_torch.utils.warnings import DirtyNameWarning, PhysicsWarning

generate_unique_name = UniqueNameGenerator(prefix="unnamed_element")

#: Tracking methods that are valid in the JAX package but belong to a later
#: slice of the port, with that slice.
_LATER_SLICE = {
    "second_order": "the nonlinear-element slice (second-order T-tensors)",
    "drift_kick_drift": "the nonlinear-element slice (Bmad-X drift-kick-drift)",
}


class Element(nn.Module):
    """Base class for elements of particle accelerators. Construct
    subclasses, not this class."""

    #: Tracking methods supported by the element type; the first is the default.
    supported_tracking_methods: list[str] = ["linear"]

    def __init__(self) -> None:
        super().__init__()
        self.tracking_method = "linear"

    def _register_parameters(
        self,
        first: tuple[str, Any],
        dtype: torch.dtype | None,
        device: torch.device | str | None,
        **others: Any,
    ) -> None:
        """Register the physical parameters as buffers. ``first`` fixes the
        dtype and device (a tensor keeps its own; Python numbers go to
        ``device``, the GPU when ``None``); ``others`` follow it."""
        name, value = first
        tensor = as_float_tensor(value, dtype=dtype, device=device)
        self.register_buffer(name, tensor)
        for other, value in others.items():
            self.register_buffer(
                other, as_float_tensor(value, dtype=tensor.dtype, device=tensor.device)
            )

    def _init_element(
        self,
        name: str | None,
        sanitize_name: bool | None,
        metadata: dict | None,
        tracking_method: str | None = None,
    ) -> None:
        name = name if name is not None else generate_unique_name()
        if not name.isidentifier():
            if sanitize_name:
                name = _sanitize(name)
            elif sanitize_name is None:
                warnings.warn(
                    f"Dirty element name {name} is not a valid Python variable "
                    "name. You will not be able to use the "
                    "`segment.element_name` syntax to access this element. Set "
                    "`sanitize_name=True` to change the name to a valid one, or "
                    "`sanitize_name=False` to silence this warning.",
                    category=DirtyNameWarning,
                    stacklevel=3,
                )
        self.name = name
        self.metadata = metadata if metadata is not None else {}
        self.tracking_method = (
            tracking_method
            if tracking_method is not None
            else self.supported_tracking_methods[0]
        )

    def __setattr__(self, key: str, value: Any) -> None:
        # An unknown tracking method warns and falls back to the first
        # supported one, as in the JAX package.
        if key == "tracking_method" and value not in self.supported_tracking_methods:
            warnings.warn(
                f"Invalid tracking method '{value}' for element "
                f"{getattr(self, 'name', '?')} of type "
                f"{self.__class__.__name__}, supported methods are "
                f"{self.supported_tracking_methods}. Using "
                f"'{self.supported_tracking_methods[0]}' instead.",
                category=PhysicsWarning,
                stacklevel=2,
            )
            value = self.supported_tracking_methods[0]
        buffers = self.__dict__.get("_buffers")
        if buffers is not None and key in buffers and not isinstance(value, torch.Tensor):
            # A Python number keeps the buffer's dtype and device.
            old = buffers[key]
            value = as_float_tensor(value, dtype=old.dtype, device=old.device)
        super().__setattr__(key, value)

    # ------------------------------------------------------------------
    # Transfer maps
    # ------------------------------------------------------------------

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        """The element's first-order 7x7 transfer map for a beam with
        reference ``energy`` and ``species``."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the element, returning the outgoing beam.

        :raises ValueError: if a parameter of the element lies on another
            device than the beam.
        """
        if not isinstance(incoming, ParticleBeam):
            raise TypeError(f"Parameter incoming is of invalid type {type(incoming)}")
        check_module_device(self, incoming.particles.device)
        return self._track(incoming)

    def forward(self, incoming: Beam) -> Beam:
        return self.track(incoming)

    def _track(self, incoming: ParticleBeam) -> ParticleBeam:
        method = self.tracking_method
        if method == "linear":
            return self._track_first_order(incoming)
        raise NotImplementedError(
            f"Tracking method {method!r} of {type(self).__name__} {self.name!r} "
            f"is not ported to PyTorch yet; it comes with {_LATER_SLICE[method]}."
        )

    def _track_first_order(self, incoming: ParticleBeam) -> ParticleBeam:
        """Linear tracking: the batched ``(..., N, 7) @ (..., 7, 7)^T`` matmul."""
        tm = self.first_order_transfer_map(incoming.energy, incoming.species)
        return ParticleBeam(
            torch.matmul(incoming.particles, tm.transpose(-1, -2)),
            incoming.energy,
            particle_charges=incoming.particle_charges,
            survival_probabilities=incoming.survival_probabilities,
            s=incoming.s + self.length,
            species=incoming.species,
        )

    # ------------------------------------------------------------------
    # Structure
    # ------------------------------------------------------------------

    @property
    def is_skippable(self) -> bool:
        """Whether the element's map can be fused with its neighbours'."""
        raise NotImplementedError

    @property
    def defining_features(self) -> list[str]:
        """Features that define the element, as constructor keywords."""
        static = ["name"]
        if len(self.supported_tracking_methods) > 1:
            static.append("tracking_method")
        return static

    def extra_repr(self) -> str:
        return ", ".join(
            f"{feature}={getattr(self, feature)!r}" for feature in self.defining_features
        )
