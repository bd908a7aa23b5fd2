"""Elegant lattice and beam import (counterpart of
``cheetah_tpu/converters/elegant.py``).

The lattice file goes through the shared parser (:mod:`.lattice_files`);
each parsed element becomes the port's element with the requested ``dtype``
on the requested ``device`` (the GPU when ``None``). Beams are read from
SDDS files, with the ``sdds`` package when it is installed and otherwise
with the built-in reader of ASCII SDDS files.
"""

from __future__ import annotations

import math
import re
import warnings
from pathlib import Path

import numpy as np
import torch

import cheetah_tpu_torch
from cheetah_tpu_torch.constants import electron_mass_eV, speed_of_light
from cheetah_tpu_torch.converters.lattice_files import (
    merge_delimiter_continued_lines,
    parse_lines,
    read_clean_lines,
    validate_understood_properties,
)
from cheetah_tpu_torch.utils.device import resolve_device
from cheetah_tpu_torch.utils.warnings import (
    NoBeamPropertiesInLatticeWarning,
    UnknownElementWarning,
)

SHARED_PROPERTIES = ["element_type", "group"]


def _drift_with_aperture(shape: str, name: str, parsed: dict, kw: dict):
    return cheetah_tpu_torch.Segment(
        elements=[
            cheetah_tpu_torch.Drift(length=parsed.get("l", 0.0), name=name + "_drift", **kw),
            cheetah_tpu_torch.Aperture(
                x_max=parsed.get("x_max", math.inf),
                y_max=parsed.get("y_max", math.inf),
                shape=shape,
                name=name + "_aperture",
                **kw,
            ),
        ],
        name=name + "_segment",
        sanitize_name=kw["sanitize_name"],
    )


def _convert_typed_element(name, parsed, kw):
    """One parsed Elegant element as the port's element; ``kw`` holds
    ``dtype``, ``device`` and ``sanitize_name``."""
    element_type = parsed["element_type"]
    ct = cheetah_tpu_torch

    def get(key, default=0.0):
        return parsed.get(key, default)

    if element_type == "sole":
        validate_understood_properties(SHARED_PROPERTIES + ["l"], parsed)
        return ct.Solenoid(length=get("l"), name=name, **kw)
    elif element_type in ("hkick", "hkic"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "kick"], parsed)
        return ct.HorizontalCorrector(length=get("l"), angle=get("kick"), name=name, **kw)
    elif element_type in ("vkick", "vkic"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "kick"], parsed)
        return ct.VerticalCorrector(length=get("l"), angle=get("kick"), name=name, **kw)
    elif element_type in ("kick", "kicker"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "hkick", "vkick"], parsed)
        return ct.CombinedCorrector(
            length=get("l"), horizontal_angle=get("hkick"), vertical_angle=get("vkick"),
            name=name, **kw,
        )
    elif element_type in ("mark", "marker", "watch"):
        if element_type == "watch":
            validate_understood_properties(SHARED_PROPERTIES + ["filename"], parsed)
        else:
            validate_understood_properties(SHARED_PROPERTIES, parsed)
        return ct.Marker(name=name, **kw)
    elif element_type in ("drift", "drif", "csrdrift", "csrdrif", "lscdrift", "lscdrif"):
        # CSR/LSC drifts are plain drifts (collective effects not imported).
        validate_understood_properties(SHARED_PROPERTIES + ["l"], parsed)
        return ct.Drift(length=get("l"), name=name, **kw)
    elif element_type in ("ecol", "rcol"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "x_max", "y_max"], parsed)
        shape = "elliptical" if element_type == "ecol" else "rectangular"
        return _drift_with_aperture(shape, name, parsed, kw)
    elif element_type in ("quad", "quadrupole", "kquad"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "k1", "tilt"], parsed)
        return ct.Quadrupole(length=get("l"), k1=get("k1"), tilt=get("tilt"), name=name, **kw)
    elif element_type in ("sext", "sextupole"):
        validate_understood_properties(SHARED_PROPERTIES + ["l", "k2", "tilt"], parsed)
        return ct.Sextupole(length=get("l"), k2=get("k2"), tilt=get("tilt"), name=name, **kw)
    elif element_type == "moni":
        validate_understood_properties(SHARED_PROPERTIES + ["l"], parsed)
        if "l" in parsed:
            half = parsed.get("l", 0.0) / 2
            return ct.Segment(
                elements=[
                    ct.Drift(length=half, name=name + "_predrift", **kw),
                    ct.BPM(name=name, **kw),
                    ct.Drift(length=half, name=name + "_postdrift", **kw),
                ],
                name=name + "_segment",
                sanitize_name=kw["sanitize_name"],
            )
        return ct.BPM(name=name, **kw)
    elif element_type == "ematrix":
        validate_understood_properties(
            SHARED_PROPERTIES + ["l", "order", "c[1-6]", "r[1-6][1-6]"], parsed
        )
        if parsed.get("order", 1) != 1:
            raise ValueError("Only first order modelling is supported")

        # Elegant initialises the matrix to zero by convention.
        R = np.zeros((7, 7))
        for i in range(6):
            for j in range(6):
                R[i, j] = parsed.get(f"r{i + 1}{j + 1}", 0.0)
            R[i, 6] = parsed.get(f"c{i + 1}", 0.0)
        R[6, 6] = 1.0
        return ct.CustomTransferMap(predefined_transfer_map=R, length=get("l"), name=name, **kw)
    elif element_type in ("rfca", "rfcw"):
        validate_understood_properties(
            SHARED_PROPERTIES + ["l", "phase", "volt", "freq"], parsed
        )
        return ct.Cavity(
            length=get("l"),
            # Elegant's phase of maximum acceleration is 90 deg, cheetah's 0.
            phase=get("phase") - 90,
            voltage=get("volt"),
            frequency=get("freq", 500e6),
            name=name,
            **kw,
        )
    elif element_type == "rfdf":
        validate_understood_properties(
            SHARED_PROPERTIES + ["l", "phase", "voltage", "freq"], parsed
        )
        return ct.TransverseDeflectingCavity(
            length=get("l"),
            phase=get("phase") - 90,
            voltage=get("voltage"),
            frequency=get("freq", 2.856e9),
            name=name,
            **kw,
        )
    elif element_type in ("sben", "csbend", "csrcsben", "csrcsbend"):
        validate_understood_properties(
            SHARED_PROPERTIES + ["l", "angle", "k1", "e1", "e2", "tilt", "hgap", "fint"],
            parsed,
        )
        return ct.Dipole(
            length=get("l"),
            angle=get("angle"),
            k1=get("k1"),
            dipole_e1=get("e1"),
            dipole_e2=get("e2"),
            tilt=get("tilt"),
            gap=2.0 * get("hgap"),
            fringe_integral=get("fint", 0.5),
            name=name,
            **kw,
        )
    elif element_type == "rben":
        validate_understood_properties(
            SHARED_PROPERTIES + ["l", "angle", "e1", "e2", "tilt"], parsed
        )
        return ct.RBend(
            length=get("l"), angle=get("angle"), rbend_e1=get("e1"), rbend_e2=get("e2"),
            tilt=get("tilt"), name=name, **kw,
        )
    elif element_type == "wiggler":
        validate_understood_properties(SHARED_PROPERTIES + ["l", "k", "poles"], parsed)
        length = get("l")
        period = 2.0 * length / parsed["poles"] if "poles" in parsed else 0.0
        return ct.Undulator(length=length, period=period, kx=get("k"), name=name, **kw)
    elif element_type in ("charge", "wake"):
        warnings.warn(
            f"Information provided in element {name} of type {element_type} "
            "cannot be imported automatically. Consider manually providing the "
            "correct information.",
            category=NoBeamPropertiesInLatticeWarning,
            stacklevel=2,
        )
        return ct.Marker(name=name, **kw)
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
    """Convert a parsed Elegant element or line (``-name`` reverses a line).

    :param device: Device of the elements; the GPU when ``None``.
    """
    device = resolve_device(device)
    is_reversed = name.startswith("-")
    name = name.removeprefix("-")
    parsed = context[name]

    if isinstance(parsed, list):
        segment = cheetah_tpu_torch.Segment(
            elements=[
                convert_element(element_name, context, sanitize_name, dtype, device)
                for element_name in parsed
            ],
            name=name,
            sanitize_name=sanitize_name,
        )
        return segment.reversed() if is_reversed else segment
    elif isinstance(parsed, dict) and "element_type" in parsed:
        kw = {"dtype": dtype, "device": device, "sanitize_name": sanitize_name}
        return _convert_typed_element(name, parsed, kw)
    else:
        raise ValueError(f"Unknown Elegant element type for name = {name!r}")


def convert_lattice(
    elegant_lattice_file_path: Path,
    name: str,
    sanitize_names: bool | None = None,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> "cheetah_tpu_torch.Element":
    """Convert an Elegant lattice file to a ``Segment``.

    :param device: Device of the lattice; the GPU when ``None``.
    """
    lines = read_clean_lines(Path(elegant_lattice_file_path))
    merged = merge_delimiter_continued_lines(lines, "&", remove_delimiter=True)
    merged = merge_delimiter_continued_lines(merged, ",", remove_delimiter=False)
    merged = merge_delimiter_continued_lines(merged, "{", remove_delimiter=False)
    context = parse_lines(merged)
    return convert_element(name, context, sanitize_names, dtype, device)


def convert_beam(
    file_path: Path,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read a beam distribution from an Elegant SDDS file.

    Uses the ``sdds`` package if installed, otherwise the built-in ASCII
    SDDS reader.

    :param device: Device of the returned tensors; the GPU when ``None``.
    :return: ``(particles (pages, N, 7), reference energy in eV (pages,),
        charges (pages, N))``.
    """
    device = resolve_device(device)
    dtype = dtype if dtype is not None else torch.get_default_dtype()
    try:
        import sdds

        sdds_data = sdds.load(str(file_path))
        column_names = sdds_data.columnName
        column_data = sdds_data.columnData
        p_central_values = (
            sdds_data.getParameterValueList("pCentral")
            if "pCentral" in sdds_data.parameterName
            else None
        )
        charge_columns = sdds_data.getColumnValueLists("q") if "q" in column_names else None
    except ImportError:
        column_names, column_data, parameters = _read_ascii_sdds(file_path)
        p_central_values = parameters.get("pcentral")
        charge_columns = (
            column_data[column_names.index("q")] if "q" in column_names else None
        )

    is_elegant = column_names[:6] == ["x", "xp", "y", "yp", "t", "p"]
    is_spiffe = column_names[:6] == ["r", "pz", "pr", "pphi", "t", "q"]
    if is_spiffe:
        raise ValueError(
            "The beam distribution is stored in the spiffe format, which is not "
            "currently supported. Use spiffe2elegant to convert the beam first."
        )
    elif not is_elegant:
        raise ValueError(
            "The first six columns of the SDDS file do not match the expected "
            "Elegant beam convention."
        )

    def tensor(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=float), dtype=dtype, device=device)

    # (6, num_pages, num_particles) -> (num_pages, num_particles, 6)
    elegant_coordinates = torch.movedim(tensor(column_data[:6]), 0, -1)
    p_central = (
        tensor(p_central_values)
        if p_central_values is not None
        else elegant_coordinates[..., 0, 5]
    )
    reference_momentum_eV = p_central * electron_mass_eV
    reference_energy_eV = torch.sqrt(reference_momentum_eV**2 + electron_mass_eV**2)

    cheetah_coordinates = elegant_to_cheetah_coordinates(elegant_coordinates, p_central)
    particle_charges = (
        tensor(charge_columns)
        if charge_columns is not None
        else torch.ones(cheetah_coordinates.shape[:-1], dtype=dtype, device=device)
    )
    return cheetah_coordinates, reference_energy_eV, particle_charges


def _read_ascii_sdds(file_path: Path) -> tuple[list[str], list, dict]:
    """Minimal self-contained reader for ASCII-mode SDDS files.

    :return: ``(column_names, column_data (cols, pages, rows), parameters)``.
    :raises ValueError: if the file is not an SDDS file or not in ASCII mode.
    """
    with open(file_path) as f:
        lines = f.read().splitlines()
    if not lines or not lines[0].startswith("SDDS"):
        raise ValueError(f"{file_path} is not an SDDS file.")

    column_names: list[str] = []
    parameter_names: list[str] = []
    mode = "ascii"
    body_start = len(lines)
    for i, line in enumerate(lines[1:], start=1):
        line = line.strip()
        if line.startswith("&column"):
            column_names.append(re.search(r"name\s*=\s*([\w\.]+)", line).group(1).lower())
        elif line.startswith("&parameter"):
            parameter_names.append(re.search(r"name\s*=\s*([\w\.]+)", line).group(1).lower())
        elif line.startswith("&data"):
            mode_match = re.search(r"mode\s*=\s*(\w+)", line)
            if mode_match:
                mode = mode_match.group(1)
            body_start = i + 1
            break
    if mode != "ascii":
        raise ValueError(
            "Binary SDDS files require the `sdds` package (pip install soliday.sdds)."
        )

    # Pages: each page is parameter values (one per line), a row count, then
    # that many rows.
    parameters: dict = {name: [] for name in parameter_names}
    pages = []
    data_lines = [
        line.strip()
        for line in lines[body_start:]
        if line.strip() and not line.strip().startswith("!")
    ]
    cursor = 0
    while cursor < len(data_lines):
        for name in parameter_names:
            try:
                parameters[name].append(float(data_lines[cursor]))
            except ValueError:
                parameters[name].append(data_lines[cursor])
            cursor += 1
        if cursor >= len(data_lines):
            break
        num_rows = int(data_lines[cursor])
        cursor += 1
        pages.append(
            [[float(value) for value in data_lines[cursor + r].split()] for r in range(num_rows)]
        )
        cursor += num_rows

    column_data = [
        [[row[c] for row in page] for page in pages] for c in range(len(column_names))
    ]
    return column_names, column_data, parameters


def elegant_to_cheetah_coordinates(
    elegant_coordinates: torch.Tensor, p_central: torch.Tensor
) -> torch.Tensor:
    r"""Convert Elegant ``[x, x', y, y', t, p]`` coordinates to cheetah's 7D
    coordinates."""
    reference_momentum_eV = p_central * electron_mass_eV
    reference_energy_eV = torch.sqrt(reference_momentum_eV**2 + electron_mass_eV**2)

    momentum_eV = elegant_coordinates[..., 5] * electron_mass_eV
    energy_eV = torch.sqrt(momentum_eV**2 + electron_mass_eV**2)
    delta_p = (elegant_coordinates[..., 5] - p_central[..., None]) / p_central[..., None]

    x_prime = elegant_coordinates[..., 1]
    y_prime = elegant_coordinates[..., 3]
    slope_norm = torch.sqrt(1.0 + torch.square(x_prime) + torch.square(y_prime))

    return torch.stack(
        [
            elegant_coordinates[..., 0],
            x_prime * (1.0 + delta_p) / slope_norm,
            elegant_coordinates[..., 2],
            y_prime * (1.0 + delta_p) / slope_norm,
            elegant_coordinates[..., 4] * speed_of_light,
            (energy_eV - reference_energy_eV[..., None]) / reference_momentum_eV[..., None],
            torch.ones_like(elegant_coordinates[..., 0]),
        ],
        dim=-1,
    )
