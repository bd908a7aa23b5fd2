"""NX Tables converter (counterpart of ``cheetah_tpu/converters/nxtables.py``).

ARES-specific (DESY) CSV format: class code -> element with its centre at
``Z_beam``; drifts are inferred between elements. The class-code dispatch
is a table, as in the JAX package. The lattice is laid out in float64 on
the host and then cast to the requested ``dtype`` and moved to the
requested ``device`` (the GPU when ``None``).
"""

from __future__ import annotations

import csv
from pathlib import Path

import torch

import cheetah_tpu_torch
from cheetah_tpu_torch.utils.device import resolve_device

# Class codes with no Cheetah representation (vacuum hardware etc.).
IGNORE_CLASSES = {
    "RSBG", "MSOB", "MSOH", "MSOG", "VVAG", "BSCL", "MIRA", "BAML", "SCRL",
    "TEMG", "FCNG", "SOLE", "EOLE", "MSOL", "BELS", "VVAF", "MIRM", "SCRY",
    "FPSA", "VPUL", "SOLC", "SCRE", "SOLX", "ICTB", "BSCS",
}

# Class codes converted to markers (monitoring / bookkeeping hardware).
MARKER_CLASSES = {
    "SOLG", "BCMG", "EOLG", "SOLS", "EOLS", "SOLA", "EOLA", "SOLT", "BSTB",
    "TORF", "EOLT", "SOLO", "EOLO", "SOLB", "EOLB", "ECHA", "MKBB", "MKBE",
    "MKPM", "EOLC", "SOLM", "EOLM", "SOLH", "BSCD", "STDE", "ECHS", "EOLH",
    "WINA", "LINA", "EOLX",
}

_SCREEN_HIGH_RES = dict(resolution=(2464, 2056), pixel_size=(3.43e-6, 2.47e-6))
_SCREEN_STANDARD = dict(resolution=(2448, 2040), pixel_size=(3.5488e-6, 2.5003e-6))
_SCREEN_LOW_RES = dict(resolution=(2464, 2056), pixel_size=(9.98e-6, 7.15e-6))


def _screen(spec):
    def build(name, **kw):
        return cheetah_tpu_torch.Screen(
            name=name, resolution=spec["resolution"], pixel_size=spec["pixel_size"], binning=1,
            **kw,
        )

    return build


def _aperture(shape):
    def build(name, **kw):
        return cheetah_tpu_torch.Aperture(
            name=name, x_max=float("inf"), y_max=float("inf"), shape=shape, **kw
        )

    return build


def _element(cls_name: str, **parameters):
    def build(name, **kw):
        return getattr(cheetah_tpu_torch, cls_name)(name=name, **parameters, **kw)

    return build


CLASS_BUILDERS = {
    "BSCX": _screen(_SCREEN_HIGH_RES),
    "BSCR": _screen(_SCREEN_STANDARD),
    "BSCM": _screen(_SCREEN_STANDARD),
    "BSCO": _screen(_SCREEN_STANDARD),
    "BSCA": _screen(_SCREEN_STANDARD),
    "BSCE": _screen(_SCREEN_LOW_RES),
    "SCRD": _screen(_SCREEN_LOW_RES),
    "BPMG": _element("BPM"),
    "BPML": _element("BPM"),
    "SLHG": _aperture("elliptical"),
    "SLHB": _aperture("rectangular"),
    "SLHS": _aperture("rectangular"),
    "MCHM": _element("HorizontalCorrector", length=0.02),
    "MCVM": _element("VerticalCorrector", length=0.02),
    "MBHL": _element("Dipole", length=0.322),
    "MBHB": _element("Dipole", length=0.22),
    "MBHO": _element(
        "Dipole",
        length=0.43852543421396856,
        angle=0.8203047484373349,
        dipole_e2=-0.7504915783575616,
    ),
    "MQZM": _element("Quadrupole", length=0.122),
    "RSBL": _element("Cavity", length=4.139, frequency=2.998e9, voltage=76e6),
    "RXBD": _element("Cavity", length=1.0, frequency=11.9952e9, voltage=0.0),
    "UNDA": _element("Undulator", length=0.25),
}


def translate_element(
    row: list[str],
    header: list[str],
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> dict | None:
    """Translate one NX Tables row into an element with its centre-s position;
    ``None`` for hardware with no simulation meaning.

    :raises ValueError: for an unknown class code, or a combined corrector
        whose name does not hold its ``X`` at index 6.
    """
    class_name = row[header.index("CLASS")]
    name = row[header.index("NAME")]
    s_position = float(row[header.index("Z_beam")])
    kw = {"dtype": dtype, "device": resolve_device(device)}

    if class_name in IGNORE_CLASSES:
        return None
    elif class_name == "MCXG":
        # Combined corrector coil pair named ...X...: split into H and V coils.
        if name[6] != "X":
            raise ValueError(f"Combined corrector {name} has no X at index 6.")
        element = cheetah_tpu_torch.Segment(
            elements=[
                cheetah_tpu_torch.HorizontalCorrector(
                    name=name[:6] + "H" + name[7:], length=5e-05, **kw
                ),
                cheetah_tpu_torch.VerticalCorrector(
                    name=name[:6] + "V" + name[7:], length=5e-05, **kw
                ),
            ],
            name=name,
        )
    elif class_name in CLASS_BUILDERS:
        element = CLASS_BUILDERS[class_name](name, **kw)
    elif class_name in MARKER_CLASSES:
        element = cheetah_tpu_torch.Marker(name=name, **kw)
    else:
        raise ValueError(f"Encountered unknown class {class_name} for element {name}")

    return {"element": element, "s_position": s_position}


def _max_length(element) -> float:
    return float(torch.max(element.length.detach()))


def convert_lattice(
    filepath: Path,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> "cheetah_tpu_torch.Element":
    """Read an NX Tables CSV file into a ``Segment``.

    The elements are placed, and the drifts between them sized, in float64
    on the host (as the JAX package does with x64 on); the lattice is then
    cast to ``dtype`` and moved to ``device``, so that a float32 lattice
    has the same elements as a float64 one (gaps computed from float32
    lengths would leave drifts of rounding size).

    :param dtype: dtype of the lattice; torch's default when ``None``.
    :param device: Device of the lattice; the GPU when ``None``.
    :raises ValueError: if two elements overlap.
    """
    device = resolve_device(device)
    dtype = dtype if dtype is not None else torch.get_default_dtype()
    filepath = Path(filepath)
    with open(filepath, "r") as csvfile:
        rows = list(csv.reader(csvfile, delimiter=","))
    header, rows = rows[0], rows[1:]

    host = {"dtype": torch.float64, "device": torch.device("cpu")}
    translated = [translate_element(row, header, **host) for row in rows]
    placed = sorted(
        (entry for entry in translated if entry is not None),
        key=lambda entry: entry["s_position"],
    )

    # Fill the gaps between centre-placed elements with drifts.
    with_drifts = [placed[0]["element"]]
    for previous, current in zip(placed[:-1], placed[1:]):
        gap = (
            current["s_position"]
            - previous["s_position"]
            - _max_length(previous["element"]) / 2
            - _max_length(current["element"]) / 2
        )
        if gap < -1e-12:
            raise ValueError(
                f"Elements {previous['element'].name} and {current['element'].name} "
                f"overlap by {gap}."
            )
        if gap > 1e-12:
            with_drifts.append(
                cheetah_tpu_torch.Drift(
                    name=f"DRIFT_{previous['element'].name}_{current['element'].name}",
                    length=[gap],
                    **host,
                )
            )
        with_drifts.append(current["element"])

    segment = cheetah_tpu_torch.Segment(elements=with_drifts, name=filepath.stem)
    # Conversion produces nested segments (the MCXG pairs); flatten them.
    return segment.flattened().to(device=device, dtype=dtype)
