"""Lattice segment (counterpart of ``cheetah_tpu/accelerator/segment.py``).

A ``Segment`` is an ``nn.Module`` holding an ordered ``nn.ModuleList`` of
elements. Its ``track`` partitions the lattice into runs of consecutive
*skippable* elements, composes each run's 7x7 transfer maps (cheap,
O(run * 7^3)) and applies the fused map to the beam once (O(N * 7^2)).
Elements are reachable as attributes by name.

A ``second_order`` element absorbs the linear runs next to it into its
T-tensor (a :class:`_SecondOrderBracket`), so the bracket moves the
particles with one quadratic map. ``track_moments`` collapses a
``ParticleBeam`` to its moments after the last element that must act on
particles, and ``track_with_readings``
collects the readings of the active observers (screens, BPMs) along the
way, tracking the stretches between them as fused runs.

The structure operations (``subcell``, ``split``, ``merge``, the lattice
passes) build new segments that share their elements' modules, as the JAX
package's segments share their leaves; ``clone`` (``Element.clone``, which
clones the elements too) copies them.
``track_checkpointed`` tracks each plan entry under
``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import Any, Iterator, Literal

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cheetah_tpu_torch.accelerator.custom_transfer_map import CustomTransferMap
from cheetah_tpu_torch.accelerator.drift import Drift
from cheetah_tpu_torch.accelerator.element import (
    Element,
    beam_device,
    host_bool,
    sum_element_lengths,
    transport_second_order,
)
from cheetah_tpu_torch.accelerator.marker import Marker
from cheetah_tpu_torch.accelerator.superimposed import Superimposed
from cheetah_tpu_torch.ops import fused_maps
from cheetah_tpu_torch.particles import Beam, ParticleBeam, Species
from cheetah_tpu_torch.utils.device import check_module_device
from cheetah_tpu_torch.utils.names import merge_element_names
from cheetah_tpu_torch.utils.profiling import count, span


class Segment(Element):
    """Segment of a particle accelerator consisting of several elements.

    :param elements: Ordered list of elements describing the accelerator
        (section). Elements are also accessible as attributes by their name.
    :param name: Unique identifier of the segment.
    """

    def __init__(
        self,
        elements: list[Element],
        name: str | None = None,
        sanitize_name: bool | None = None,
        metadata: dict | None = None,
    ) -> None:
        super().__init__()
        self.elements = nn.ModuleList(elements)
        self._init_element(name, sanitize_name, metadata)

    def __getattr__(self, name: str) -> Any:
        # nn.Module resolves parameters, buffers and submodules first; only
        # then are element names searched (duplicates return a list).
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("__"):
                raise
        elements = self.__dict__.get("_modules", {}).get("elements", ())
        matches = [element for element in elements if element.name == name]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            return matches
        raise AttributeError(f"'{type(self).__name__}' object has no attribute {name!r}")

    @property
    def element_names(self) -> list[str]:
        """Ordered list of the names of the elements in the segment."""
        return [element.name for element in self.elements]

    # ------------------------------------------------------------------
    # Structure
    # ------------------------------------------------------------------

    def element_index(self, element_name: str) -> int:
        """Index of the first element with the given name.

        :raises ValueError: if no element has that name.
        """
        try:
            return self.element_names.index(element_name)
        except ValueError:
            raise ValueError(f"Element '{element_name}' not found in segment.")

    def subcell(
        self,
        start: str | None = None,
        end: str | None = None,
        include_start: bool = True,
        include_end: bool = True,
    ) -> "Segment":
        """The elements between two named elements, as a new segment.

        :raises ValueError: if ``start`` or ``end`` is not in the segment.
        """
        names = self.element_names
        if start is not None and start not in names:
            raise ValueError(f"Element {start} is not part of the segment.")
        if end is not None and end not in names:
            raise ValueError(f"Element {end} is not part of the segment.")

        subcell = []
        is_in_subcell = start is None
        for element in self.elements:
            if element.name == start:
                is_in_subcell = True
                if include_start:
                    subcell.append(element)
                continue
            if element.name == end:
                if include_end and is_in_subcell:
                    subcell.append(element)
                break
            if is_in_subcell:
                subcell.append(element)
        return self.__class__(subcell)

    def flattened(self) -> "Segment":
        """One flat segment of the leaf elements: nested segments and the
        halves of ``Superimposed`` elements resolved."""
        flattened_elements: list[Element] = []
        for element in self.elements:
            if isinstance(element, (Segment, Superimposed)):
                flattened_elements += element.flattened().elements
            else:
                flattened_elements.append(element)
        return self.__class__(flattened_elements, name=self.name, sanitize_name=False)

    def reversed(self) -> "Segment":
        """The segment with its elements (and those of nested segments) in
        reverse order."""
        reversed_elements = [
            element.reversed() if isinstance(element, Segment) else element
            for element in reversed(self.elements)
        ]
        return self.__class__(
            reversed_elements, name=f"{self.name}_reversed", sanitize_name=False
        )

    def partition_at(
        self, element_name: str, mode: Literal["before", "after", "both"] = "both"
    ) -> tuple[Element, ...]:
        """Split the segment around a named element: ``(before, element,
        after)`` for ``mode="both"``, else two segments with the element at
        the start of the second (``"before"``) or the end of the first
        (``"after"``)."""
        index = self.element_index(element_name)
        elements = list(self.elements)
        pre_cell = self.__class__(elements[: index + 1] if mode == "after" else elements[:index])
        post_cell = self.__class__(elements[index:] if mode == "before" else elements[index + 1 :])
        return (pre_cell, elements[index], post_cell) if mode == "both" else (pre_cell, post_cell)

    def split(self, resolution: torch.Tensor | float) -> list[Element]:
        """Every element split into pieces no longer than ``resolution``."""
        return [piece for element in self.elements for piece in element.split(resolution)]

    def merge(self, other: "Segment") -> "Segment":
        """The two segments' elements in one segment."""
        return self.__class__(
            [*self.elements, *other.elements],
            name=merge_element_names(self.name, other.name),
            sanitize_name=False,
            metadata={**self.metadata, **other.metadata},
        )

    # ------------------------------------------------------------------
    # Lattice passes (on the host, before tracking)
    # ------------------------------------------------------------------

    def transfer_maps_merged(
        self, incoming_beam: Beam, except_for: list[str] | None = None
    ) -> "Segment":
        """Runs of skippable elements merged into :class:`CustomTransferMap`
        elements.

        :param incoming_beam: Beam entering the segment; a merged map is
            built at the energy of the beam where its run starts.
        :param except_for: Names of elements to keep unmerged (the tunables).
        """
        except_for = except_for if except_for is not None else []

        merged_elements: list[Element] = []
        skippable_elements: list[Element] = []
        tracked_beam = incoming_beam
        for element in self.elements:
            if element.is_skippable and element.name not in except_for:
                skippable_elements.append(element)
                continue
            if len(skippable_elements) == 1:
                merged_elements.append(skippable_elements[0])
                tracked_beam = skippable_elements[0].track(tracked_beam)
            elif len(skippable_elements) > 1:
                merged_elements.append(
                    CustomTransferMap.from_merging_elements(
                        skippable_elements, incoming_beam=tracked_beam
                    )
                )
                tracked_beam = merged_elements[-1].track(tracked_beam)
            skippable_elements = []
            merged_elements.append(element)
            tracked_beam = element.track(tracked_beam)

        if skippable_elements:
            merged_elements.append(
                CustomTransferMap.from_merging_elements(
                    skippable_elements, incoming_beam=tracked_beam
                )
            )
        return self.__class__(merged_elements, name=self.name, sanitize_name=False)

    def without_inactive_markers(self, except_for: list[str] | None = None) -> "Segment":
        """The segment without its markers, but those named in ``except_for``."""
        except_for = except_for if except_for is not None else []
        return self.__class__(
            [
                element
                for element in self.elements
                if not isinstance(element, Marker) or element.name in except_for
            ],
            name=self.name,
            sanitize_name=False,
        )

    def without_inactive_zero_length_elements(
        self, except_for: list[str] | None = None
    ) -> "Segment":
        """The segment without its inactive elements of zero length, but
        those named in ``except_for``."""
        except_for = except_for if except_for is not None else []
        return self.__class__(
            [
                element
                for element, has_length in zip(self.elements, _lengths_nonzero(self.elements))
                if has_length or _is_active(element) or element.name in except_for
            ],
            name=self.name,
            sanitize_name=False,
        )

    def inactive_elements_as_drifts(self, except_for: list[str] | None = None) -> "Segment":
        """The segment with each inactive element that has a length replaced
        by a drift of that length, but those named in ``except_for``."""
        except_for = except_for if except_for is not None else []
        return self.__class__(
            [
                element
                if _is_active(element) or not has_length or element.name in except_for
                else Drift(element.length, name=element.name, sanitize_name=False)
                for element, has_length in zip(self.elements, _lengths_nonzero(self.elements))
            ],
            name=self.name,
            sanitize_name=False,
        )

    def with_consecutive_elements_merged(
        self, except_for: list[str] | None = None
    ) -> "Segment":
        """The segment with consecutive elements of one type merged where
        their type can (``Element.merge``); nested segments merge their own
        elements. Elements named in ``except_for`` are kept as they are."""
        except_for = except_for if except_for is not None else []

        merged_elements: list[Element] = []
        current = self.elements[0]
        for next_element in list(self.elements)[1:]:
            if current.name not in except_for:
                if type(current) is Segment:
                    current = current.with_consecutive_elements_merged(except_for=except_for)
                elif type(current) is type(next_element) and next_element.name not in except_for:
                    merged = current.merge(next_element)
                    if merged is not None:
                        current = merged
                        continue
            merged_elements.append(current)
            current = next_element
        merged_elements.append(current)

        return self.__class__(
            merged_elements,
            name=self.name,
            sanitize_name=False,
            metadata=dict(self.metadata),
        )

    @property
    def is_skippable(self) -> bool:
        return all(element.is_skippable for element in self.elements)

    @property
    def length(self) -> torch.Tensor:
        """The sum of the elements' lengths; 0 for an empty segment (a CPU
        scalar, which adds to a tensor on any device)."""
        return sum_element_lengths([element.length for element in self.elements])

    def first_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor | None:
        if not self.is_skippable:
            return None
        return run_transfer_map(list(self.elements), energy, species)

    def _track(self, incoming: Beam) -> Beam:
        """Consecutive skippable elements are fused into one composed
        transfer map applied with one matmul; the others track one by one."""
        if not self.elements:
            return incoming
        with span("ctt.segment.track"):
            if self.is_skippable:
                return self._track_first_order(incoming)
            for todo in self._plan():
                incoming = todo._track(incoming)
            return incoming

    def track_checkpointed(self, incoming: Beam) -> Beam:
        """:meth:`track` with each plan entry (a fused run or an element that
        breaks fusion) under ``torch.utils.checkpoint``: backward keeps only
        the beam between entries and runs each entry's forward again, which
        trades compute for memory on long nonlinear lines (many space-charge
        kicks over large particle arrays). Values equal :meth:`track`'s;
        gradients equal them up to the rounding of the space-charge deposits,
        whose float atomics may add in another order when run again.
        Tracking draws no random numbers, so no generator state is saved.
        """
        check_module_device(self, beam_device(incoming))
        with span("ctt.segment.track"):
            for todo in self._plan():
                incoming = checkpoint(
                    _track_todo, todo, incoming, use_reentrant=False, preserve_rng_state=False
                )
            return incoming

    def track_moments(
        self,
        incoming: Beam,
        second_order: Literal["closure", "particles"] = "closure",
    ) -> Beam:
        """Track only the beam's first and second moments.

        Through a linear map ``M`` the moments of a particle distribution
        are exactly ``mu' = M mu``, ``cov' = M cov M^T``. So a
        :class:`ParticleBeam` is tracked as particles through every element
        up to and including the last one that must act on particles (space
        charge, an active aperture or screen, ...), collapsed there to its
        weighted mean and covariance (``as_parameter_beam``), and the
        trailing skippable runs transport the moments alone: O(7^3) per
        instance instead of O(N * 7^2). For linear stretches the result is
        :meth:`track`'s sample moments up to float rounding.

        With ``second_order="closure"`` (the default), ``second_order``
        elements and their brackets move the moments too, by the Gaussian
        closure of the quadratic map
        (:func:`~cheetah_tpu_torch.accelerator.element.second_order_moment_transport`):
        exact for the Gaussian that ``(mu, cov)`` describes, but not the
        tracked particles' sample moments (their 3rd and 4th moments are
        dropped). ``"particles"`` tracks particles through them instead.

        :param second_order: ``"closure"`` (default) or ``"particles"``.
        :return: A :class:`ParameterBeam` with the tracked moments (a
            :class:`ParameterBeam` input is simply tracked).
        """
        check_module_device(self, beam_device(incoming))

        def moment_transportable(todo: Element) -> bool:
            if todo.is_skippable:
                return True
            if second_order != "closure":
                return False
            return isinstance(todo, _SecondOrderBracket) or _is_second_order_leaf(todo)

        with span("ctt.segment.track"):
            todos = self._plan()
            boundary = 0
            for index, todo in enumerate(todos):
                if not moment_transportable(todo):
                    boundary = index + 1
            for todo in todos[:boundary]:
                incoming = todo._track(incoming)
            if isinstance(incoming, ParticleBeam):
                incoming = incoming.as_parameter_beam()
            for todo in todos[boundary:]:
                incoming = todo._track(incoming)
            return incoming

    def track_with_readings(self, incoming: Beam) -> tuple[Beam, dict[str, torch.Tensor]]:
        """Track a beam and collect the readings of the observers on the
        way: every active element with an ``observe`` method (Screen, BPM)
        gives ``readings[element.name]``, read from the beam at its place.
        The elements between two observers are tracked as one segment, so
        their skippable runs fuse as in :meth:`track`.

        :return: ``(outgoing_beam, readings)``.
        """
        check_module_device(self, beam_device(incoming))
        readings: dict[str, torch.Tensor] = {}
        pending: list[Element] = []

        def flush(beam: Beam) -> Beam:
            if len(pending) == 1:
                beam = pending[0]._track(beam)
            elif pending:
                beam = _run(pending)._track(beam)
            pending.clear()
            return beam

        with span("ctt.segment.track"):
            for element in self.elements:
                if isinstance(element, (Segment, Superimposed)):
                    if _contains_active_observer(element):
                        incoming = flush(incoming)
                        sub_segment = (
                            element if isinstance(element, Segment) else element._segment()
                        )
                        incoming, sub_readings = sub_segment.track_with_readings(incoming)
                        readings.update(sub_readings)
                    else:
                        pending.append(element)
                elif _is_active_observer(element):
                    incoming = flush(incoming)
                    readings[element.name] = element.observe(incoming)
                    incoming = element._track(incoming)
                else:
                    pending.append(element)
            return flush(incoming), readings

    def beam_along_segment_generator(
        self, incoming: Beam, resolution: torch.Tensor | float | None = None
    ) -> Iterator[Beam]:
        """Yield the beam at the entrance and after every element.

        :param resolution: If given, the elements are first split into
            pieces no longer than this (m), and the beam is yielded after
            every piece.
        """
        if resolution is not None:
            yield from self.__class__(
                self.split(resolution), name=f"{self.name}_split"
            ).beam_along_segment_generator(incoming)
            return
        check_module_device(self, beam_device(incoming))
        yield incoming
        for element in self.elements:
            incoming = element._track(incoming)
            yield incoming

    def get_beam_attrs_along_segment(
        self,
        attr_names: tuple[str, ...] | str,
        incoming: Beam,
        resolution: float | None = None,
    ) -> tuple[torch.Tensor, ...] | torch.Tensor:
        """Any beam attribute at the entrance and after every element,
        stacked along a new dimension just before the attribute's own
        trailing dimensions."""
        names = attr_names if isinstance(attr_names, tuple) else (attr_names,)
        values = zip(
            *(
                tuple(getattr(beam, name) for name in names)
                for beam in self.beam_along_segment_generator(incoming, resolution)
            )
        )
        stacked = tuple(
            torch.stack(
                torch.broadcast_tensors(*along),
                dim=-(incoming.UNVECTORIZED_NUM_ATTR_DIMS.get(name, 0) + 1),
            )
            for along, name in zip(values, names)
        )
        return stacked if isinstance(attr_names, tuple) else stacked[0]

    def explain_plan(self) -> str:
        """What :meth:`track` runs, one line per plan entry: which elements
        fuse into one matmul or one quadratic map, and which break the
        fusion. Informational only; the text is the JAX package's.
        """

        def names(elements) -> str:
            labels = [element.name or type(element).__name__ for element in elements]
            if len(labels) > 8:
                labels = labels[:4] + ["..."] + labels[-3:]
            return ", ".join(labels)

        lines = []
        for index, todo in enumerate(self._plan(), start=1):
            if isinstance(todo, _SecondOrderBracket):
                parts = []
                if len(todo.upstream):
                    parts.append(f"{len(todo.upstream)} upstream")
                parts.append(f"{type(todo.element).__name__} '{todo.element.name or ''}'")
                if len(todo.downstream):
                    parts.append(f"{len(todo.downstream)} downstream")
                lines.append(
                    f"{index}. second-order bracket (1 quadratic apply): " + " + ".join(parts)
                )
            elif isinstance(todo, Segment) and todo.is_skippable:
                flat = todo.flattened().elements
                lines.append(
                    f"{index}. fused linear run (1 matmul, {len(flat)} elements): {names(flat)}"
                )
            else:
                method = getattr(todo, "tracking_method", None)
                suffix = f" [{method}]" if method and method != "linear" else ""
                lines.append(f"{index}. {type(todo).__name__} '{todo.name or ''}'{suffix}")
        return "\n".join(lines)

    def _plan(self) -> list[Element]:
        """Partition the elements into fused skippable runs and individual
        non-skippable elements, then fold the linear runs next to
        ``second_order`` elements into their T-tensors
        (:meth:`_fuse_second_order_brackets`)."""
        with span("ctt.plan"):
            todos: list[Element] = []
            run: list[Element] = []
            for element in self.elements:
                if element.is_skippable:
                    run.append(element)
                    continue
                if run:
                    todos.append(_run(run))
                    run = []
                todos.append(element)
            if run:
                todos.append(_run(run))
            return self._fuse_second_order_brackets(todos)

    @staticmethod
    def _fuse_second_order_brackets(todos: list[Element]) -> list[Element]:
        """Fold skippable linear runs into adjacent second-order T-tensors.

        With ``p_6 = 1``, ``out_i = T_ijk p_j p_k`` holds constant, linear
        and quadratic terms, so a second-order map between two linear maps
        is exactly a second-order map, ``T'_iab = R_il T_ljk M_ja M_kb``.
        Greedy from the left: each second-order element takes the run before
        it, and the run after it unless the todo after that run is itself
        second-order (which takes that run as its own).
        """
        fused: list[Element] = []
        index = 0

        def is_run(todo: Element) -> bool:
            return isinstance(todo, Segment) and todo.is_skippable

        while index < len(todos):
            todo = todos[index]
            if _is_second_order_leaf(todo):
                upstream: list[Element] = []
                if fused and is_run(fused[-1]):
                    upstream = list(fused.pop().elements)
                downstream: list[Element] = []
                if (
                    index + 1 < len(todos)
                    and is_run(todos[index + 1])
                    and not (index + 2 < len(todos) and _is_second_order_leaf(todos[index + 2]))
                ):
                    downstream = list(todos[index + 1].elements)
                    index += 1
                if upstream or downstream:
                    fused.append(_SecondOrderBracket(upstream, todo, downstream))
                else:
                    fused.append(todo)
            else:
                fused.append(todo)
            index += 1
        return fused

    def set_attrs_on_every_element(
        self,
        filter_type: type[Element] | tuple[type[Element], ...] | None = None,
        is_recursive: bool = True,
        **kwargs: Any,
    ) -> None:
        """Set the attributes ``kwargs`` on every element of the segment, or
        on every element of ``filter_type`` only.

        :param filter_type: Element type (or tuple of types) to change;
            every element when ``None``, nested segments included.
        :param is_recursive: Whether to descend into nested segments that
            ``filter_type`` does not select.
        """
        for element in self.elements:
            if filter_type is None or isinstance(element, filter_type):
                for key, value in kwargs.items():
                    setattr(element, key, value)
            elif is_recursive and isinstance(element, Segment):
                element.set_attrs_on_every_element(
                    filter_type=filter_type, is_recursive=True, **kwargs
                )

    @classmethod
    def from_lattice_json(
        cls,
        filepath: str,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "Segment":
        """Load a lattice from a LatticeJSON file.

        :param dtype: dtype of the physical parameters; torch's default
            when ``None``.
        :param device: Device of the lattice; the GPU when ``None``.
        """
        from cheetah_tpu_torch import latticejson

        return latticejson.load_cheetah_model(filepath, dtype=dtype, device=device)

    def to_lattice_json(
        self,
        filepath: str,
        title: str | None = None,
        info: str = "This is a placeholder lattice description",
    ) -> None:
        """Save this lattice to a LatticeJSON file."""
        from cheetah_tpu_torch import latticejson

        latticejson.save_cheetah_model(self, filepath, title, info)

    @classmethod
    def from_ocelot(
        cls,
        cell,
        name: str | None = None,
        sanitize_names: bool | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        **kwargs,
    ) -> "Segment":
        """Translate an Ocelot cell (list of Ocelot elements) to a
        ``Segment``.

        :param device: Device of the lattice; the GPU when ``None``.
        """
        from cheetah_tpu_torch.converters import ocelot
        from cheetah_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        converted = [
            ocelot.convert_element(element, sanitize_name=sanitize_names, dtype=dtype,
                                   device=device)
            for element in cell
        ]
        return cls(converted, name=name, sanitize_name=sanitize_names, **kwargs)

    @classmethod
    def from_bmad(
        cls,
        bmad_lattice_file_path: str,
        environment_variables: dict | None = None,
        sanitize_names: bool | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "Segment":
        """Read a ``Segment`` from a Bmad lattice file.

        :param device: Device of the lattice; the GPU when ``None``.
        """
        from pathlib import Path

        from cheetah_tpu_torch.converters import bmad

        return bmad.convert_lattice(
            Path(bmad_lattice_file_path), environment_variables, sanitize_names, dtype, device
        )

    @classmethod
    def from_elegant(
        cls,
        elegant_lattice_file_path: str,
        name: str,
        sanitize_names: bool | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "Segment":
        """Read a ``Segment`` from an Elegant lattice file.

        :param device: Device of the lattice; the GPU when ``None``.
        """
        from pathlib import Path

        from cheetah_tpu_torch.converters import elegant

        return elegant.convert_lattice(
            Path(elegant_lattice_file_path), name, sanitize_names, dtype, device
        )

    @classmethod
    def from_nx_tables(
        cls,
        filepath,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> "Element":
        """Read an NX Tables CSV file (ARES-specific format) into a
        ``Segment``.

        :param device: Device of the lattice; the GPU when ``None``.
        """
        from pathlib import Path

        from cheetah_tpu_torch.converters import nxtables

        return nxtables.convert_lattice(Path(filepath), dtype, device)

    # ------------------------------------------------------------------
    # Visualisation (delegations into cheetah_tpu_torch.plotting)
    # ------------------------------------------------------------------

    def plot(self, s=0.0, vector_idx: tuple | None = None, ax=None):
        """Draw the lattice cartoon."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_segment_cartoon(self, s, vector_idx, ax)

    def plot_mean_and_std(self, incoming, resolution=None, vector_idx=None, axx=None, axy=None):
        """Plot beam position and size along s."""
        from cheetah_tpu_torch import plotting

        reference_segment = self.clone()  # Prevent plotting side effects
        return plotting.plot_mean_and_std(
            reference_segment, incoming, resolution, vector_idx, axx, axy
        )

    def plot_overview(self, incoming, resolution=None, vector_idx=None, fig=None):
        """Lattice cartoon under the beam position and size plots."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_overview(self, incoming, resolution, vector_idx, fig)

    def plot_beam_attrs(self, incoming, attr_names, resolution=None, vector_idx=None, ax=None):
        """Plot any beam attributes along s."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_beam_attrs(self, incoming, attr_names, resolution, vector_idx, ax)

    def plot_beam_attrs_over_lattice(
        self, incoming, attr_names, resolution=None, vector_idx=None, fig=None
    ):
        """Beam attributes over the lattice cartoon."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_beam_attrs_over_lattice(
            self, incoming, attr_names, resolution, vector_idx, fig
        )

    def plot_twiss(self, incoming, vector_idx=None, ax=None):
        """Plot the beta functions along s."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_twiss(self, incoming, vector_idx, ax)

    def plot_twiss_over_lattice(self, incoming, vector_idx=None, fig=None):
        """The beta functions over the lattice cartoon."""
        from cheetah_tpu_torch import plotting

        return plotting.plot_twiss_over_lattice(self, incoming, vector_idx, fig)

    def to_mesh(
        self,
        cuteness: float | dict = 1.0,
        asset_version: str = "v1.2.0",
        show_download_progress: bool = True,
    ):
        """3D scene of the whole lattice, chaining the elements' meshes and
        transforms; returns the scene and the lattice's exit transform.
        Requires ``trimesh``."""
        import trimesh

        scene = trimesh.Scene()
        input_transform = trimesh.transformations.identity_matrix()
        for element in self.elements:
            element_mesh, element_output_transform = element.to_mesh(
                cuteness=cuteness,
                asset_version=asset_version,
                show_download_progress=show_download_progress,
            )
            if element_mesh is not None:
                element_mesh.apply_transform(input_transform)
            input_transform = input_transform @ element_output_transform
            scene.add_geometry(element_mesh)

        return scene, input_transform

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["elements"]

    def extra_repr(self) -> str:
        # The elements print as child modules.
        return f"name={self.name!r}"


def _track_todo(todo: Element, incoming: Beam) -> Beam:
    return todo._track(incoming)


def _is_active(element: Element) -> bool:
    return bool(getattr(element, "is_active", False))


def _lengths_nonzero(elements) -> list[bool]:
    """Per element ``any(length != 0)``, read on the host."""
    return [host_bool(torch.any(element.length.detach() != 0)) for element in elements]


def _is_second_order_leaf(element: Element) -> bool:
    """Whether the element is a ``second_order``-tracked leaf (not a nested
    segment, which plans its own elements)."""
    return (
        not isinstance(element, Segment)
        and getattr(element, "tracking_method", "linear") == "second_order"
    )


def _is_active_observer(element: Element) -> bool:
    return hasattr(element, "observe") and getattr(element, "is_active", False)


def _contains_active_observer(element: Element) -> bool:
    """Whether the (possibly nested) element holds an active observer that
    :meth:`Segment.track_with_readings` must stop at."""
    if isinstance(element, Segment):
        return any(_contains_active_observer(child) for child in element.elements)
    if isinstance(element, Superimposed):
        return _contains_active_observer(element._segment())
    return _is_active_observer(element)


def run_transfer_map(
    elements: list[Element], energy: torch.Tensor, species: Species
) -> torch.Tensor:
    """The map ``M_{n-1} @ ... @ M_0 @ I`` of consecutive skippable
    elements at ``energy``. One ``fused_run_map`` operator builds it where
    every element's type names a kind it takes (``fused_opcode``) and
    nothing tracks a gradient (:func:`fused_maps.takes`); otherwise the
    elements' maps are built and multiplied one by one (the composite,
    counted as ``fused_run_map_composite``)."""
    opcodes = [element.fused_opcode for element in elements]
    if opcodes and None not in opcodes:
        parameters = [
            getattr(element, name)
            for element, opcode in zip(elements, opcodes)
            for name in fused_maps.KINDS[opcode].attributes
        ]
        if fused_maps.takes(parameters, energy, species.mass_eV):
            return fused_maps.FUSED_RUN_MAP(parameters, energy, species.mass_eV, opcodes)
    count("fused_run_map_composite")
    tm = torch.eye(7, dtype=energy.dtype, device=energy.device)
    for element in elements:
        tm = element.first_order_transfer_map(energy, species) @ tm
    return tm


def _run(elements: list[Element]) -> Segment:
    """A run of elements that tracking builds and throws away (a plan's
    fused run, the stretch between two observers). It takes a fixed name
    instead of a generated one: a name drawn from the element counter would
    change the counter on every call, and a compiled step would be traced
    anew on every call."""
    return Segment(list(elements), name="fused_run", sanitize_name=False)


class _SecondOrderBracket(Element):
    """A linear run, a ``second_order`` element and a linear run, tracked as
    one quadratic map ``T'_iab = R_il T_ljk M_ja M_kb``: exactly the three
    parts in sequence, up to float rounding, with one pass over the
    particles instead of three. Made by :meth:`Segment._plan` only."""

    def __init__(
        self, upstream: list[Element], element: Element, downstream: list[Element]
    ) -> None:
        super().__init__()
        self.upstream = nn.ModuleList(upstream)
        self.element = element
        self.downstream = nn.ModuleList(downstream)
        self._init_element(f"{element.name}_bracket", False, None)

    @property
    def length(self) -> torch.Tensor:
        total = self.element.length
        for part in (*self.upstream, *self.downstream):
            total = total + part.length
        return total

    @property
    def is_skippable(self) -> bool:
        return False

    def fused_second_order_transfer_map(
        self, energy: torch.Tensor, species: Species
    ) -> torch.Tensor:
        """The bracket's folded 7x7x7 tensor ``R_il T_ljk M_ja M_kb``."""
        with span("ctt.maps"):
            T = self.element.second_order_transfer_map(energy, species)
            if len(self.upstream):
                M = run_transfer_map(list(self.upstream), energy, species)
                T = torch.einsum("...ijk,...ja,...kb->...iab", T, M, M)
            if len(self.downstream):
                R = run_transfer_map(list(self.downstream), energy, species)
                T = torch.einsum("...il,...ljk->...ijk", R, T)
            return T

    def _track(self, incoming: Beam) -> Beam:
        T = self.fused_second_order_transfer_map(incoming.energy, incoming.species)
        return transport_second_order(T, incoming, self.length)
