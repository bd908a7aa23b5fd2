"""LatticeJSON save and load (counterpart of ``cheetah_tpu/latticejson.py``).

A ``Segment`` is written as an ``elements`` dict of ``[class name, params]``,
a ``lattices`` dict of cells (lists of element names) and a ``root`` cell.
Tensors become plain lists; the format is the JAX package's, so a file
written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Any

import torch

from cheetah_tpu_torch.utils.device import resolve_device


def feature_to_plain(value: Any) -> Any:
    """A tensor-valued feature as a JSON-serialisable value."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().tolist()
    return value


def plain_to_feature(
    value: Any, dtype: torch.dtype | None = None, device: torch.device | None = None
) -> Any:
    """A JSON value as a tensor where the element constructors expect one.
    Strings, bools, ints, dicts and lists of those stay as they are
    (``resolution``, ``binning``, ``num_steps``, ``cavity_type``,
    ``fringe_at``, ``metadata``, ...)."""
    if (
        value is None
        or isinstance(value, (str, bool, int, dict))
        or (
            isinstance(value, (tuple, list))
            and all(isinstance(entry, (str, bool, int)) for entry in value)
        )
    ):
        return value
    return torch.tensor(value, dtype=dtype, device=device)


def convert_element(element, elements_dict: dict | None = None) -> tuple[str, str, dict]:
    """Deconstruct an element into ``(name, class name, params)``; elements
    that are features of it (``Superimposed.base_element``, ...) are added
    to ``elements_dict`` and named in ``params``."""
    from cheetah_tpu_torch.accelerator import Element

    if elements_dict is None:
        elements_dict = {}

    params = {}
    for feature in element.defining_features:
        if feature == "name":
            continue
        value = getattr(element, feature)
        if isinstance(value, Element):
            sub_name, sub_class, sub_params = convert_element(value, elements_dict)
            elements_dict[sub_name] = [sub_class, sub_params]
            params[feature] = sub_name
        else:
            params[feature] = feature_to_plain(value)
    # The metadata does not change the simulation, but it round-trips.
    params["metadata"] = element.metadata
    return element.name, element.__class__.__name__, params


def convert_segment(segment) -> tuple[dict, dict]:
    """Deconstruct a segment into its ``elements`` and ``lattices`` dicts."""
    from cheetah_tpu_torch.accelerator import Segment

    elements: dict = {}
    lattices: dict = {}
    cell = []
    for element in segment.elements:
        if isinstance(element, Segment):
            sub_elements, sub_lattices = convert_segment(element)
            elements.update(sub_elements)
            lattices.update(sub_lattices)
        else:
            _, element_class, element_params = convert_element(element, elements)
            elements[element.name] = [element_class, element_params]
        cell.append(element.name)
    lattices[segment.name] = cell
    return elements, lattices


class CompactJSONEncoder(json.JSONEncoder):
    """JSON encoder that indents only the first two levels (the LatticeJSON
    style)."""

    def encode(self, obj, level: int = 0) -> str:
        if isinstance(obj, dict) and level < 2:
            item_indent = (level + 1) * self.indent * " "
            items = ",\n".join(
                f"{item_indent}{json.dumps(key)}: {self.encode(value, level=level + 1)}"
                for key, value in obj.items()
            )
            closing_indent = level * self.indent * " "
            newline = "\n" if level == 0 else ""
            return f"{{\n{items}\n{closing_indent}}}{newline}"
        return json.dumps(obj)


def save_cheetah_model(
    segment,
    filename: str,
    title: str | None = None,
    info: str = "This is a placeholder lattice description",
) -> None:
    """Save a ``Segment`` to a LatticeJSON file."""
    if title is None:
        title = segment.name if segment.name is not None else "Unnamed Lattice"
    lattice_dict = {
        "version": "cheetah-tpu-0.1",
        "title": title,
        "info": info,
        "root": segment.name if segment.name is not None else "cell",
    }
    lattice_dict["elements"], lattice_dict["lattices"] = convert_segment(segment)
    with open(filename, "w") as f:
        f.write(json.dumps(lattice_dict, cls=CompactJSONEncoder, indent=4))


def parse_element(
    name: str,
    lattice_dict: dict,
    dtype: torch.dtype | None = None,
    device: torch.device | None = None,
):
    """Build the element named ``name`` of a lattice dict. Every occurrence
    builds a new module, so an element named twice in a cell is two
    modules."""
    import cheetah_tpu_torch

    class_name, params = lattice_dict["elements"][name]
    element_class = getattr(cheetah_tpu_torch, class_name)
    converted = {
        key: (
            parse_element(value, lattice_dict, dtype, device)
            if isinstance(value, str) and value in lattice_dict["elements"]
            else plain_to_feature(value, dtype, device)
        )
        for key, value in params.items()
    }
    return element_class(name=name, dtype=dtype, device=device, **converted)


def parse_segment(
    name: str,
    lattice_dict: dict,
    dtype: torch.dtype | None = None,
    device: torch.device | None = None,
):
    """Build the segment named ``name`` of a lattice dict."""
    import cheetah_tpu_torch

    elements = [
        (
            parse_segment(element_name, lattice_dict, dtype, device)
            if element_name in lattice_dict["lattices"]
            else parse_element(element_name, lattice_dict, dtype, device)
        )
        for element_name in lattice_dict["lattices"][name]
    ]
    return cheetah_tpu_torch.Segment(elements=elements, name=name)


def load_cheetah_model(
    filename: str,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
):
    """Load a ``Segment`` from a LatticeJSON file.

    :param dtype: dtype of the physical parameters; torch's default when
        ``None``.
    :param device: Device of the lattice; the GPU when ``None``.
    """
    device = resolve_device(device)
    with open(filename, "r") as f:
        lattice_dict = json.load(f)
    return parse_segment(lattice_dict["root"], lattice_dict, dtype, device)
