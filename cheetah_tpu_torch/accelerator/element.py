"""Element base class (counterpart of ``cheetah_tpu/accelerator/element.py``).

Elements are ``nn.Module``s. Physical parameters (length, k1, misalignment,
...) are registered buffers, not ``nn.Parameter``s: assigning a new tensor
(``segment.AREAMQZM1.k1 = torch.linspace(-20, 20, 4096)``) replaces the
buffer, and ``.to(device)`` moves them all. Configuration (name, tracking
method, grid shapes) is plain Python attributes.

Tracking checks that every buffer lies on the beam's device and raises
otherwise: nothing moves between devices silently.

Elements compare by value (``__eq__``, as in the JAX package) but hash by
identity: ``nn.Module`` keeps sets of modules (``named_modules``, ``.to``,
``state_dict``), which an unhashable module would break.
"""

from __future__ import annotations

import copy
import warnings
from typing import Any

import torch
from torch import nn

from cheetah_tpu_torch.ops import fused_transport
from cheetah_tpu_torch.ops.transfer_maps import identity_transfer_map  # noqa: F401 (re-exported)
from cheetah_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam, Species
from cheetah_tpu_torch.utils.device import as_float_tensor, check_module_device
from cheetah_tpu_torch.utils.profiling import count, span
from cheetah_tpu_torch.utils.names import UniqueNameGenerator
from cheetah_tpu_torch.utils.names import sanitize_name as _sanitize
from cheetah_tpu_torch.utils.warnings import DirtyNameWarning, PhysicsWarning

generate_unique_name = UniqueNameGenerator(prefix="unnamed_element")


def sum_element_lengths(lengths: list[torch.Tensor]) -> torch.Tensor:
    """Broadcast sum of the elements' lengths; 0 for no element (a CPU
    scalar, which adds to a tensor on any device)."""
    if not lengths:
        return torch.zeros(())
    total = lengths[0]
    for length in lengths[1:]:
        total = total + length
    return total


def host_bool(value: torch.Tensor) -> bool:
    """``bool(value)``, read on the host (a device sync on the card), counted
    in the ``host_reads`` counter of :mod:`cheetah_tpu_torch.utils.profiling`."""
    count("host_reads")
    return bool(value)


def num_pieces(length: torch.Tensor, resolution: torch.Tensor | float) -> int:
    """How many pieces of equal length ``split`` cuts ``length`` into so that
    none is longer than ``resolution``: ``ceil(max |length| / resolution)``,
    read on the host (counted in ``host_reads``). A gradient on ``length``
    still reaches the pieces, which are ``length / count``."""
    count("host_reads")
    return int(torch.ceil(torch.max(torch.abs(length.detach())) / resolution))


def any_nonzero(value: torch.Tensor) -> bool:
    """``bool(any(value != 0))``, read on the host: an ``is_active`` test for
    the set-up passes, never for tracking."""
    return host_bool(torch.any(value.detach() != 0))


def second_order_moment_transport(
    T: torch.Tensor, mu: torch.Tensor, cov: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Exact first and second moments of ``out_i = T_ijk p_j p_k`` for a
    Gaussian ``p`` (Isserlis' theorem). With ``B_i = (T_i + T_i^T) / 2``:

    .. math::
        \mu'_i = \mu^T B_i \mu + \mathrm{tr}(B_i \Sigma), \qquad
        \Sigma'_{il} = 2\,\mathrm{tr}(B_i \Sigma B_l \Sigma)
                       + 4\,(B_i \mu)^T \Sigma (B_l \mu).

    For a ``T`` that holds a linear map alone (in ``T[..., :, 6, :]``, with
    ``p_6 = 1``) this is the congruence ``mu' = M mu``, ``cov' = M cov
    M^T``. O(7^4) per instance, independent of the particle count.
    """
    B = 0.5 * (T + T.transpose(-1, -2))
    mu_out = torch.einsum("...ijk,...j,...k->...i", B, mu, mu) + torch.einsum(
        "...ijk,...jk->...i", B, cov
    )
    BS = torch.einsum("...ijk,...kl->...ijl", B, cov)  # B_i @ Sigma
    Bmu = torch.einsum("...ijk,...k->...ij", B, mu)  # B_i @ mu
    cov_out = 2.0 * torch.einsum("...ijk,...lkj->...il", BS, BS) + 4.0 * torch.einsum(
        "...ij,...jk,...lk->...il", Bmu, cov, Bmu
    )
    return mu_out, cov_out


def apply_second_order_map(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 7x7x7 second-order map: ``out_i = sum_jk T_ijk p_j p_k``.

    Unbatched particles ``(N, 7)`` (the vectorised-lattice case): the
    quadratic form factors through the instance-independent outer products
    ``S[n, jk] = p_j p_k``, ``(N, 49)``, and the contraction is one matmul
    ``(N, 49) @ (..., 49, 7)``. Batched particles: ``S`` would be 7 times the
    particle array for every instance, so the contraction is unrolled over
    the 7 output components, each a ``(..., N, 7) @ (..., 7, 7)`` matmul and
    a multiply-reduce.
    """
    if p.ndim == 2:
        S = (p[:, :, None] * p[:, None, :]).reshape(p.shape[0], 49)
        T2 = T.reshape(*T.shape[:-3], 7, 49)
        return S @ T2.transpose(-1, -2)
    return torch.stack(
        [
            torch.sum((p @ T[..., i, :, :].transpose(-1, -2)) * p, dim=-1)
            for i in range(7)
        ],
        dim=-1,
    )


class Element(nn.Module):
    """Base class for elements of particle accelerators. Construct
    subclasses, not this class."""

    #: Tracking methods supported by the element type; the first is the default.
    supported_tracking_methods: list[str] = ["linear"]
    #: The opcode (``ops/fused_maps.py`` ``KINDS``) with which one kernel
    #: launch builds the first-order maps of a fused run of this type.
    fused_opcode: int | None = None

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        # A subclass may build another map: it inherits no opcode.
        cls.fused_opcode = cls.__dict__.get("fused_opcode")

    def __init__(self) -> None:
        super().__init__()
        self.tracking_method = self.supported_tracking_methods[0]

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

    def transfer_map(self, energy: torch.Tensor, species: Species) -> torch.Tensor:
        """Deprecated alias of :meth:`first_order_transfer_map`."""
        warnings.warn(
            "The `transfer_map` method is deprecated and will be removed in a "
            "future version. Use `first_order_transfer_map` instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.first_order_transfer_map(energy, species)

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        """The element's first-order 7x7 transfer map for a beam with
        reference ``energy`` and ``species``."""
        raise NotImplementedError

    def second_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        """The element's second-order 7x7x7 T-tensor ``T_ijk`` such that
        ``out_i = sum_jk T_ijk in_j in_k``."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the element, returning the outgoing beam.

        :raises ValueError: if a parameter of the element lies on another
            device than the beam.
        """
        check_module_device(self, beam_device(incoming))
        return self._track(incoming)

    def forward(self, incoming: Beam) -> Beam:
        return self.track(incoming)

    def _track(self, incoming: Beam) -> Beam:
        method = self.tracking_method
        if method == "linear":
            return self._track_first_order(incoming)
        if method == "second_order":
            return self._track_second_order(incoming)
        if method == "drift_kick_drift":
            return self._track_drift_kick_drift(incoming)
        raise ValueError(
            f"Invalid tracking method {method}. For element of type "
            f"{type(self).__name__}, supported methods are "
            f"{self.supported_tracking_methods}."
        )

    def _track_first_order(self, incoming: Beam) -> Beam:
        """Linear tracking: the moments' congruence ``mu' = M mu``,
        ``cov' = M cov M^T`` for a :class:`ParameterBeam`; for a
        :class:`ParticleBeam` the batched ``(..., N, 7) @ (..., 7, 7)^T``,
        by the ``transport_moments`` operator where nothing tracks a
        gradient (:func:`fused_transport.takes`; the outgoing beam's moment
        memo then holds the operator's sums), else by ``torch.matmul``
        (counted as ``fused_transport_matmul``)."""
        with span("ctt.maps"):
            tm = self.first_order_transfer_map(incoming.energy, incoming.species)
        with span("ctt.transport"):
            if isinstance(incoming, ParameterBeam):
                return ParameterBeam(
                    torch.matmul(tm, incoming.mu[..., None]).squeeze(-1),
                    tm @ incoming.cov @ tm.transpose(-1, -2),
                    incoming.energy,
                    total_charge=incoming.total_charge,
                    s=incoming.s + self.length,
                    species=incoming.species,
                )
            particles, weights = incoming.particles, incoming.survival_probabilities
            sums = None
            if fused_transport.takes(particles, tm, weights):
                particles, *sums = fused_transport.TRANSPORT_MOMENTS(particles, tm, weights)
            else:
                count("fused_transport_matmul")
                particles = torch.matmul(particles, tm.transpose(-1, -2))
            outgoing = ParticleBeam(
                particles,
                incoming.energy,
                particle_charges=incoming.particle_charges,
                survival_probabilities=weights,
                s=incoming.s + self.length,
                species=incoming.species,
            )
            if sums is not None:
                outgoing._seed_moments(*sums)
            return outgoing

    def _track_second_order(self, incoming: Beam) -> Beam:
        """Second-order tracking, ``out_i = sum_jk T_ijk in_j in_k``; a
        :class:`ParameterBeam`'s Gaussian moments go through the quadratic
        map exactly (:func:`second_order_moment_transport`)."""
        with span("ctt.maps"):
            T = self.second_order_transfer_map(incoming.energy, incoming.species)
        return transport_second_order(T, incoming, self.length)

    def _track_drift_kick_drift(self, incoming: Beam) -> Beam:
        raise NotImplementedError(
            f"{type(self).__name__} does not support drift-kick-drift tracking."
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

    @property
    def defining_tensors(self) -> list[str]:
        """The defining features that are tensors (or plain numbers)."""
        return [
            feature
            for feature in self.defining_features
            if isinstance(getattr(self, feature), (torch.Tensor, float, int))
            and not isinstance(getattr(self, feature), bool)
        ]

    def clone(self) -> "Element":
        """Copy of the element. Tensors are copied with ``Tensor.clone`` (a
        gradient still reaches the original's tensors), element-valued
        features are cloned, dicts and lists deep-copied: an in-place edit of
        the copy never reaches the original."""
        kwargs = {
            feature: _cloned(getattr(self, feature)) for feature in self.defining_features
        }
        own = next(iter(self._buffers.values()), None)
        if own is not None:
            # Parameters the constructor makes from Python numbers (a
            # Marker's zero length) follow the original's dtype and device.
            kwargs.update(dtype=own.dtype, device=own.device)
        return self.__class__(
            **kwargs, metadata=copy.deepcopy(self.metadata), sanitize_name=False
        )

    def split(self, resolution: torch.Tensor | float) -> list["Element"]:
        """Split the element into pieces no longer than ``resolution`` m.
        An element that cannot be split returns ``[self]``."""
        return [self]

    def merge(self, other: "Element") -> "Element | None":
        """The element that ``self`` followed by ``other`` (of the same type)
        make, or ``None`` where the type cannot merge."""
        return None

    def sanitize_name(self) -> None:
        """Make the element's name a valid Python identifier."""
        self.name = _sanitize(self.name)

    def extra_repr(self) -> str:
        return ", ".join(
            f"{feature}={getattr(self, feature)!r}" for feature in self.defining_features
        )

    # ------------------------------------------------------------------
    # Visualisation
    # ------------------------------------------------------------------

    def plot(self, s, vector_idx: tuple | None = None, ax=None):
        """Draw a 1D cartoon of this element at position ``s``."""
        from cheetah_tpu_torch.plotting import plot_element

        return plot_element(self, s, vector_idx, ax)

    def to_mesh(
        self,
        cuteness: float | dict = 1.0,
        asset_version: str = "v1.2.0",
        show_download_progress: bool = True,
    ):
        """3D mesh of the element and the transform that places the next
        element's mesh downstream of it. Requires ``trimesh``; the mesh is
        ``None``, with a warning, if the asset is unavailable.

        :param cuteness: Scale of the mesh, or a dict of scales by element
            name, by element class or ``"*"``.
        """
        try:
            import trimesh
        except ImportError:
            raise ImportError("To use 3D visualisation, trimesh must be installed.")

        from cheetah_tpu_torch.utils import assets
        from cheetah_tpu_torch.utils.warnings import VisualizationWarning

        length = float(torch.max(self.length.detach()))
        output_transform = trimesh.transformations.translation_matrix([0.0, 0.0, length])

        snake_case = "".join(
            "_" + c.lower() if c.isupper() else c for c in type(self).__name__
        ).lstrip("_")
        mesh = assets.load_3d_asset(
            f"{snake_case}.glb",
            branch_or_tag=asset_version,
            show_download_progress=show_download_progress,
        )
        if mesh is None:
            warnings.warn(
                f"Could not load 3D mesh for element {self.name} of type "
                f"{type(self).__name__}. The element will not be visualised.",
                category=VisualizationWarning,
                stacklevel=2,
            )
            return None, output_transform

        # Scale to the physical length (meshes of thin elements keep their
        # default size, with a warning if a length was expected).
        if abs(length) > 0.0:
            _, _, mesh_length = mesh.extents
            mesh.apply_scale(length / mesh_length)
        elif "length" in self.defining_features:
            warnings.warn(
                f"Element {self.name} of type {type(self).__name__} has a "
                "length of zero. The mesh is therefore scaled to a default "
                "size and does not accurately represent the element's length.",
                category=VisualizationWarning,
                stacklevel=2,
            )

        if isinstance(cuteness, dict):
            cuteness = cuteness.get(
                self.name, cuteness.get(type(self), cuteness.get("*", 1.0))
            )
        mesh.apply_scale(cuteness)

        return mesh, output_transform

    def __eq__(self, other: object) -> bool:
        """Equal type and equal defining features, the name aside; nested
        elements must have equal names and metadata too, as in the JAX
        package's pytree comparison. Reads tensors back to the host."""
        if type(self) is not type(other):
            return False
        return all(
            _features_equal(getattr(self, feature), getattr(other, feature))
            for feature in self.defining_features
            if feature != "name"
        )

    # Identity hash, unlike the JAX package's unhashable elements: nn.Module
    # keeps modules in sets (named_modules, .to, state_dict).
    __hash__ = object.__hash__


def _cloned(value: Any) -> Any:
    if isinstance(value, (torch.Tensor, Element)):
        return value.clone()
    if isinstance(value, nn.ModuleList):
        return [element.clone() for element in value]
    if isinstance(value, (dict, list)):
        return copy.deepcopy(value)
    return value


def _nested_equal(a: "Element", b: "Element") -> bool:
    return a.name == b.name and a.metadata == b.metadata and a == b


def _features_equal(a: Any, b: Any) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.shape == b.shape and not host_bool(torch.any(a != b.to(a.device)))
    if isinstance(a, Element) or isinstance(b, Element):
        return isinstance(a, Element) and isinstance(b, Element) and _nested_equal(a, b)
    if isinstance(a, nn.ModuleList) or (
        isinstance(a, (list, tuple)) and any(isinstance(item, Element) for item in a)
    ):
        return (
            isinstance(b, (list, tuple, nn.ModuleList))
            and len(a) == len(b)
            and all(_features_equal(x, y) for x, y in zip(a, b))
        )
    return a == b


def validate_understood_kwargs(kwargs: dict[str, Any], understood: list[str]) -> None:
    """Raise on constructor keywords that are not understood.

    :raises TypeError: naming the first keyword not in ``understood``.
    """
    for key in kwargs:
        if key not in understood:
            raise TypeError(f"Unexpected keyword argument {key!r}")


class ZeroLengthMixin:
    """Mixin giving a thin element a constant zero ``length``, in the dtype
    and on the device of its first parameter."""

    @property
    def length(self) -> torch.Tensor:
        return next(self.buffers()).new_zeros(())


def transport_second_order(T: torch.Tensor, incoming: Beam, length: torch.Tensor) -> Beam:
    """The beam after the quadratic map ``T`` over ``length``: the moments'
    Gaussian closure for a :class:`ParameterBeam`, the map applied to every
    particle of a :class:`ParticleBeam`."""
    with span("ctt.transport"):
        if isinstance(incoming, ParameterBeam):
            mu, cov = second_order_moment_transport(T, incoming.mu, incoming.cov)
            return ParameterBeam(
                mu,
                cov,
                incoming.energy,
                total_charge=incoming.total_charge,
                s=incoming.s + length,
                species=incoming.species,
            )
        return ParticleBeam(
            apply_second_order_map(T, incoming.particles),
            incoming.energy,
            particle_charges=incoming.particle_charges,
            survival_probabilities=incoming.survival_probabilities,
            s=incoming.s + length,
            species=incoming.species,
        )


def dkd_outgoing(
    incoming: ParticleBeam,
    coordinates: tuple[torch.Tensor, ...],
    ref_energy: torch.Tensor,
    length: torch.Tensor,
) -> ParticleBeam:
    """The beam after a drift-kick-drift map that gave ``(x, px, y, py, tau,
    delta)`` and the reference energy ``ref_energy``."""
    coordinates = torch.broadcast_tensors(*coordinates)
    return ParticleBeam(
        torch.stack([*coordinates, torch.ones_like(coordinates[0])], dim=-1),
        ref_energy,
        particle_charges=incoming.particle_charges,
        survival_probabilities=incoming.survival_probabilities,
        s=incoming.s + length,
        species=incoming.species,
    )


def require_particle_beam(incoming: Beam) -> ParticleBeam:
    """``incoming``, which a drift-kick-drift map needs as a :class:`ParticleBeam`.

    :raises TypeError: for any other beam.
    """
    if not isinstance(incoming, ParticleBeam):
        raise TypeError(
            "Drift-kick-drift tracking is currently only supported for `ParticleBeam`."
        )
    return incoming


def beam_device(beam: Beam) -> torch.device:
    """The device of a beam's tensors.

    :raises TypeError: if ``beam`` is neither a particle nor a parameter beam.
    """
    if isinstance(beam, ParticleBeam):
        return beam.particles.device
    if isinstance(beam, ParameterBeam):
        return beam.mu.device
    raise TypeError(f"Parameter incoming is of invalid type {type(beam)}")
