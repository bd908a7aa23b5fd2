"""Element holding an arbitrary 7x7 transfer map (counterpart of
``cheetah_tpu/accelerator/custom_transfer_map.py``).

``from_merging_elements`` folds a run of skippable elements into one map.
The JAX package groups the elements by structure and builds each group's
maps in one compiled ``vmap``, then folds them in a compiled ``lax.scan``:
devices against XLA's compile and dispatch costs. Here each element builds
its map at the incoming energy and the maps are multiplied in order.
"""

from __future__ import annotations

import torch

from cheetah_tpu_torch.accelerator.element import Element, identity_transfer_map
from cheetah_tpu_torch.particles import Beam
from cheetah_tpu_torch.particles.species import Species
from cheetah_tpu_torch.utils.device import is_transformed


class CustomTransferMap(Element):
    """An element with a given first-order transfer map.

    :param predefined_transfer_map: Transfer map of shape ``(..., 7, 7)``.
        Its seventh row must be ``[0, 0, 0, 0, 0, 0, 1]``.
    :param length: Length of the element in m (0 if not given).
    :param name: Unique identifier of the element.
    :param device: Device of a map given as nested Python lists; the GPU
        when ``None``.
    """

    def __init__(
        self,
        predefined_transfer_map: torch.Tensor | list,
        length: torch.Tensor | float | None = None,
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self._register_parameters(
            ("predefined_transfer_map", predefined_transfer_map),
            dtype,
            device,
            length=length if length is not None else 0.0,
        )
        tm = self.predefined_transfer_map
        assert tm.shape[-2:] == (7, 7)
        # A transform's argument cannot be read on the host.
        if not is_transformed(tm):
            assert bool(torch.all(tm[..., -1, :-2] == 0.0)) and bool(
                torch.all(tm[..., -1, -1] == 1.0)
            ), "The seventh row of the transfer map must be [0, 0, 0, 0, 0, 0, 1]."
        self._init_element(name, sanitize_name, metadata)

    @classmethod
    def from_merging_elements(
        cls, elements: list[Element], incoming_beam: Beam
    ) -> "CustomTransferMap":
        """Fold the transfer maps of consecutive skippable elements into one,
        ``M_{n-1} @ ... @ M_0``.

        Every map is built at the *incoming* beam energy: a skippable
        element's map is affine and does not change the reference energy
        (the invariant that fused ``Segment.track`` relies on too). The
        empty merge is the identity.

        :param incoming_beam: Beam entering the elements.
        """
        assert all(element.is_skippable for element in elements), (
            "Combining the elements in a Segment that is not skippable will "
            "result in incorrect tracking results."
        )
        energy = incoming_beam.energy
        if not elements:
            return cls(
                identity_transfer_map(energy),
                length=energy.new_zeros(()),
                name="combined_",
                sanitize_name=False,
            )
        species = incoming_beam.species
        tm = elements[0].first_order_transfer_map(energy, species)
        length = elements[0].length
        for element in elements[1:]:
            tm = element.first_order_transfer_map(energy, species) @ tm
            length = length + element.length
        name = "combined_" + "_".join(element.name for element in elements)
        return cls(tm, length=length, name=name, sanitize_name=False)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        return self.predefined_transfer_map

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "predefined_transfer_map"]
