"""Ocelot lattice converter (counterpart of ``cheetah_tpu/converters/ocelot.py``).

Dispatches on the Ocelot element's *class names* (its MRO), as the JAX
package does, so it works with any Ocelot-compatible objects and without
the ocelot package importable. Every element gets the requested ``dtype``
and ``device`` (the GPU when ``None``).
"""

from __future__ import annotations

import warnings

import torch

import cheetah_tpu_torch
from cheetah_tpu_torch.utils.device import resolve_device
from cheetah_tpu_torch.utils.warnings import DefaultParameterWarning, UnknownElementWarning


def convert_element(
    element,
    sanitize_name: bool | None = None,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> "cheetah_tpu_torch.Element":
    """Translate an Ocelot element to the port's element.

    NOTE: Objects not supported are translated to drift sections. ``Monitor``
    objects become Screens when "BSC" appears in their id (with default,
    ARES-specific screen properties) and BPMs when "BPM" appears; otherwise
    Markers.

    :param device: Device of the element; the GPU when ``None``.
    """
    ct = cheetah_tpu_torch
    class_names = [cls.__name__ for cls in type(element).__mro__]
    name = element.id
    kw = {"name": name, "sanitize_name": sanitize_name, "dtype": dtype,
          "device": resolve_device(device)}

    if "Quadrupole" in class_names:
        return ct.Quadrupole(length=element.l, k1=element.k1, **kw)
    elif "Sextupole" in class_names:
        return ct.Sextupole(length=element.l, k2=element.k2, **kw)
    elif "Solenoid" in class_names:
        return ct.Solenoid(length=element.l, k=element.k, **kw)
    elif "Hcor" in class_names:
        return ct.HorizontalCorrector(length=element.l, angle=element.angle, **kw)
    elif "Vcor" in class_names:
        return ct.VerticalCorrector(length=element.l, angle=element.angle, **kw)
    elif "RBend" in class_names:
        return ct.RBend(
            length=element.l,
            angle=element.angle,
            rbend_e1=element.e1 - element.angle / 2,
            rbend_e2=element.e2 - element.angle / 2,
            tilt=element.tilt,
            fringe_integral=element.fint,
            fringe_integral_exit=element.fintx,
            gap=element.gap,
            **kw,
        )
    elif "SBend" in class_names or "Bend" in class_names:
        return ct.Dipole(
            length=element.l,
            angle=element.angle,
            dipole_e1=element.e1,
            dipole_e2=element.e2,
            tilt=element.tilt,
            fringe_integral=element.fint,
            fringe_integral_exit=element.fintx,
            gap=element.gap,
            **kw,
        )
    elif "TWCavity" in class_names:
        return ct.Cavity(
            length=element.l, voltage=element.v * 1e9, frequency=element.freq,
            phase=element.phi, cavity_type="traveling_wave", **kw,
        )
    elif "TDCavity" in class_names or "Cavity" in class_names:
        # NOTE: TDCavity falls back to a standing-wave Cavity, as in the JAX
        # package and the reference.
        return ct.Cavity(
            length=element.l, voltage=element.v * 1e9, frequency=element.freq,
            phase=element.phi, cavity_type="standing_wave", **kw,
        )
    elif "Monitor" in class_names:
        if "BSC" in name:
            # NOTE: Pattern specific to ARES; screen properties are defaults.
            warnings.warn(
                "Diagnostic screen was converted with default screen properties.",
                category=DefaultParameterWarning,
                stacklevel=2,
            )
            return ct.Screen(resolution=(2448, 2040), pixel_size=[3.5488e-6, 2.5003e-6], **kw)
        elif "BPM" in name:
            return ct.BPM(**kw)
        else:
            return ct.Marker(**kw)
    elif "Marker" in class_names:
        return ct.Marker(**kw)
    elif "Undulator" in class_names:
        return ct.Undulator(
            length=element.l, period=element.lperiod, kx=element.Kx, ky=element.Ky, **kw
        )
    elif "Aperture" in class_names:
        shape_translation = {"rect": "rectangular", "elip": "elliptical"}
        return ct.Aperture(
            x_max=element.xmax, y_max=element.ymax, shape=shape_translation[element.type],
            is_active=True, **kw,
        )
    elif "Drift" in class_names:
        return ct.Drift(length=element.l, **kw)
    else:
        warnings.warn(
            f"Unknown element {name} of type {type(element)}, replacing with drift section.",
            category=UnknownElementWarning,
            stacklevel=2,
        )
        return ct.Drift(length=element.l, **kw)


def subcell_of_ocelot(cell: list, start: str, end: str) -> list:
    """Extract a subcell ``[start, end]`` from an Ocelot cell."""
    subcell = []
    is_in_subcell = False
    for element in cell:
        if element.id == start:
            is_in_subcell = True
        if is_in_subcell:
            subcell.append(element)
        if element.id == end:
            break
    return subcell
