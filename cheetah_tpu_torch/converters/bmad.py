"""Bmad lattice import (counterpart of ``cheetah_tpu/converters/bmad.py``).

Element dispatch over the shared lattice-file parser
(:mod:`.lattice_files`); every element gets the requested ``dtype`` and
``device`` (the GPU when ``None``).
"""

from __future__ import annotations

import math
import os
import warnings
from pathlib import Path

import torch

import cheetah_tpu_torch
from cheetah_tpu_torch.converters.lattice_files import (
    merge_delimiter_continued_lines,
    parse_lines,
    read_clean_lines,
    validate_understood_properties,
)
from cheetah_tpu_torch.utils.device import resolve_device
from cheetah_tpu_torch.utils.warnings import UnknownElementWarning

SHARED_PROPERTIES = ["element_type", "alias", "type"]


def _collimator(shape: str, name: str, parsed: dict, kw: dict):
    return cheetah_tpu_torch.Segment(
        elements=[
            cheetah_tpu_torch.Drift(length=parsed.get("l", 0.0), name=name + "_drift", **kw),
            cheetah_tpu_torch.Aperture(
                x_max=parsed.get("x_limit", math.inf),
                y_max=parsed.get("y_limit", math.inf),
                shape=shape,
                name=name + "_aperture",
                **kw,
            ),
        ],
        name=name,
        sanitize_name=kw["sanitize_name"],
    )


def _convert_typed_element(name, parsed, kw):
    """One parsed Bmad element as the port's element; ``kw`` holds
    ``dtype``, ``device`` and ``sanitize_name``."""
    element_type = parsed["element_type"]
    ct = cheetah_tpu_torch

    def get(key, default=0.0):
        return parsed.get(key, default)

    if element_type == "marker":
        validate_understood_properties(SHARED_PROPERTIES, parsed)
        return ct.Marker(name=name, **kw)
    elif element_type in ("monitor", "instrument"):
        validate_understood_properties(SHARED_PROPERTIES + ["l"], parsed)
        # Drift if it has a length, else marker.
        if "l" in parsed:
            return ct.Drift(length=parsed["l"], name=name, **kw)
        return ct.Marker(name=name, **kw)
    elif element_type in ("pipe", "drift", "patch"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "descrip"], parsed)
        return ct.Drift(length=get("l"), name=name, **kw)
    elif element_type == "hkicker":
        validate_understood_properties(SHARED_PROPERTIES + ["kick"], parsed)
        return ct.HorizontalCorrector(length=get("l"), angle=get("kick"), name=name, **kw)
    elif element_type == "vkicker":
        validate_understood_properties(SHARED_PROPERTIES + ["kick"], parsed)
        return ct.VerticalCorrector(length=get("l"), angle=get("kick"), name=name, **kw)
    elif element_type == "sbend":
        validate_understood_properties(
            SHARED_PROPERTIES + ["hgap", "l", "angle", "e1", "e2", "fint", "fintx", "ref_tilt"],
            parsed,
        )
        return ct.Dipole(
            length=get("l"),
            gap=2 * get("hgap"),
            angle=get("angle"),
            dipole_e1=get("e1"),
            dipole_e2=get("e2"),
            tilt=get("ref_tilt"),
            fringe_integral=get("fint"),
            fringe_integral_exit=parsed.get("fintx"),
            name=name,
            **kw,
        )
    elif element_type == "quadrupole":
        validate_understood_properties(SHARED_PROPERTIES + ["l", "k1", "tilt"], parsed)
        return ct.Quadrupole(length=get("l"), k1=get("k1"), tilt=get("tilt"), name=name, **kw)
    elif element_type == "sextupole":
        validate_understood_properties(SHARED_PROPERTIES + ["l", "k2", "tilt"], parsed)
        return ct.Sextupole(length=get("l"), k2=get("k2"), tilt=get("tilt"), name=name, **kw)
    elif element_type == "solenoid":
        validate_understood_properties(SHARED_PROPERTIES + ["l", "ks"], parsed)
        return ct.Solenoid(length=get("l"), k=get("ks"), name=name, **kw)
    elif element_type == "lcavity":
        validate_understood_properties(
            SHARED_PROPERTIES + ["l", "rf_frequency", "voltage", "phi0"], parsed
        )
        # phi0 in turns; the phase in degrees, computed in the lattice's
        # dtype as the JAX package does.
        phi0 = torch.as_tensor(
            get("phi0"), dtype=kw["dtype"] or torch.get_default_dtype(), device=kw["device"]
        )
        return ct.Cavity(
            length=get("l"),
            voltage=get("voltage"),
            phase=torch.rad2deg(-phi0 * 2 * math.pi),
            frequency=parsed["rf_frequency"],
            cavity_type=parsed.get("cavity_type", "standing_wave"),
            name=name,
            **kw,
        )
    elif element_type in ("rcollimator", "ecollimator"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "x_limit", "y_limit"], parsed)
        shape = "rectangular" if element_type == "rcollimator" else "elliptical"
        return _collimator(shape, name, parsed, kw)
    elif element_type == "wiggler":
        validate_understood_properties(SHARED_PROPERTIES + ["l", "l_period"], parsed)
        return ct.Undulator(length=get("l"), period=parsed["l_period"], name=name, **kw)
    else:
        warnings.warn(
            f"Element {name} of type {element_type} cannot be converted "
            "correctly. Using drift section instead.",
            category=UnknownElementWarning,
            stacklevel=2,
        )
        return ct.Drift(length=get("l"), name=name, **kw)


def convert_element(
    name: str,
    context: dict,
    sanitize_name: bool | None = None,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> "cheetah_tpu_torch.Element":
    """Convert a parsed Bmad element or line.

    :param device: Device of the elements; the GPU when ``None``.
    """
    device = resolve_device(device)
    parsed = context[name]
    if isinstance(parsed, list):
        return cheetah_tpu_torch.Segment(
            elements=[
                convert_element(element_name, context, sanitize_name, dtype, device)
                for element_name in parsed
            ],
            name=name,
            sanitize_name=sanitize_name,
        )
    elif isinstance(parsed, dict) and "element_type" in parsed:
        kw = {"dtype": dtype, "device": device, "sanitize_name": sanitize_name}
        return _convert_typed_element(name, parsed, kw)
    else:
        raise ValueError(f"Unknown Bmad element type for name = {name!r}")


def convert_lattice(
    bmad_lattice_file_path: Path,
    environment_variables: dict | None = None,
    sanitize_names: bool | None = None,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> "cheetah_tpu_torch.Element":
    """Convert a Bmad lattice file to a ``Segment``.

    :param environment_variables: Set in ``os.environ`` before the file is
        read, for ``$NAME`` parts of included paths.
    :param device: Device of the lattice; the GPU when ``None``.
    """
    if environment_variables is not None:
        for key, value in environment_variables.items():
            os.environ[key] = value

    resolved = Path(
        *[
            os.environ[part[1:]] if part.startswith("$") else part
            for part in Path(bmad_lattice_file_path).parts
        ]
    )

    lines = read_clean_lines(resolved)
    merged = merge_delimiter_continued_lines(lines, "&", remove_delimiter=True)
    merged = merge_delimiter_continued_lines(merged, ",", remove_delimiter=False)
    merged = merge_delimiter_continued_lines(merged, "{", remove_delimiter=False)
    context = parse_lines(merged)

    return convert_element(context["__use__"], context, sanitize_names, dtype, device)
