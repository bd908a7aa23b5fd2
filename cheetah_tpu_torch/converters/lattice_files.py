"""Shared parsing engine for Bmad/Elegant-style lattice files (a copy of
``cheetah_tpu/converters/lattice_files.py``, which is plain Python).

Equivalent of the reference's Fortran-namelist engine
(``converters/utils/fortran_namelist.py:40-452``): cleans and merges lines,
evaluates expressions (infix with RPN fallback), and executes
property/variable/element/line/overlay/use statements into a context dict.
The regex grammar matches the reference's, since it *is* the file-format spec.
"""

from __future__ import annotations

import math
import os
import re
import warnings
from copy import deepcopy
from pathlib import Path
from typing import Any

import scipy.constants

from cheetah_tpu_torch.constants import electron_mass_eV
from cheetah_tpu_torch.converters.expressions import evaluate_infix, evaluate_rpn
from cheetah_tpu_torch.utils.warnings import NotUnderstoodPropertyWarning, PhysicsWarning

ELEMENT_NAME = r'(?:[a-z0-9_\-\.]+|"[a-z0-9_\-\.\:]+")'
PROPERTY_NAME = r"[a-z0-9_\*:]+"
VARIABLE_NAME = r"[a-z0-9_]+"
PROPERTY_ASSIGNMENT = f"({PROPERTY_NAME})" + r"\[([a-z0-9_%]+)\]\s*=(.*)"
VARIABLE_ASSIGNMENT = f"({VARIABLE_NAME})" + r"\s*=(.*)"
ELEMENT_DEFINITION = (
    f"({ELEMENT_NAME})" + r"\s*\:\s*" + f"({VARIABLE_NAME})" + r"(\s*\,(.*))?"
)
LINE_DEFINITION = f"({ELEMENT_NAME})" + r"\s*\:\s*line\s*=\s*\((.*)\)"
USE_LINE = r'use\s*\,\s*([a-z0-9_]+|"[a-z0-9_\-\.\:]+")'
OVERLAY_DEFINITION = (
    f"({ELEMENT_NAME})" + r"\s*\:\s*overlay\s*=\s*\{(.*)\}\s*\,\s*var\s*=\s*"
)
OVERLAY_KNOT = (
    OVERLAY_DEFINITION + r"\{\s*([a-z0-9_]+)\s*\}\s*\,\s*x_knot\s*=\s*\{(.*)\}"
)
OVERLAY_EXPRESSION = OVERLAY_DEFINITION + r"\{(.*)\}\s*(\,.*)*"


def read_clean_lines(lattice_file_path: Path) -> list[str]:
    """Recursively read lines, stripping comments/empties and inlining
    ``call, file =`` includes (with ``$ENV`` resolution)."""
    with open(lattice_file_path) as f:
        raw = f.readlines()

    lines = [re.sub(r"!.*", "", line.strip()) for line in raw]
    lines = [line for line in lines if line]

    expanded = []
    for line in lines:
        if line.startswith("call, file ="):
            called_path = Path(line.split("=", 1)[1].strip())
            resolved = Path(
                *[
                    os.environ[part[1:]] if part.startswith("$") else part
                    for part in called_path.parts
                ]
            )
            if not resolved.is_absolute():
                resolved = lattice_file_path.parent / resolved
            expanded += read_clean_lines(resolved)
        else:
            expanded.append(line)

    # Lowercase late: environment variables are case-sensitive.
    return [line.lower().strip() for line in expanded]


def merge_delimiter_continued_lines(
    lines: list[str], delimiter: str, remove_delimiter: bool = False
) -> list[str]:
    """Merge lines ending with ``delimiter`` into the following line."""
    merged: list[str | None] = deepcopy(list(lines))
    for i in range(len(merged) - 1):
        if merged[i] is not None and merged[i].endswith(delimiter):
            offset = 1
            while merged[i].endswith(delimiter):
                continuation = merged[i + offset]
                if remove_delimiter:
                    merged[i] = merged[i][:-1] + continuation
                else:
                    merged[i] = merged[i] + continuation
                merged[i + offset] = None
                offset += 1
    return [line.strip() for line in merged if line is not None]


def evaluate_expression(expression: str, context: dict) -> Any:
    """Evaluate an expression: int/float literal, keyword, variable, infix,
    then RPN; falls back to the raw string with a warning."""
    for cast in (int, float):
        try:
            return cast(expression)
        except ValueError:
            pass

    if expression in ["open", "electron", "t", "f", "traveling_wave", "full"]:
        return expression
    if expression in context:
        return context[expression]

    try:
        return evaluate_infix(expression, context)
    except SyntaxError:
        try:
            return evaluate_rpn(expression, context)
        except SyntaxError:
            warnings.warn(
                f"Could not evaluate expression '{expression}'. It will now be "
                "treated as a string. This may lead to unexpected behaviour.",
                category=PhysicsWarning,
                stacklevel=2,
            )
            return expression


def _resolve_wildcard(pattern: str, context: dict) -> list[str]:
    """Object names matching a ``type::name*`` wildcard pattern."""
    object_type, object_name = pattern.split("::")
    regex = object_name.replace("*", ".*").replace("%", ".")
    return [
        key
        for key in context
        if re.fullmatch(regex, key)
        and isinstance(context[key], dict)
        and context[key].get("element_type") == object_type
    ]


def _assign_property(line: str, context: dict) -> None:
    match = re.fullmatch(PROPERTY_ASSIGNMENT, line)
    object_name = match.group(1).strip()
    property_name = match.group(2).strip()
    value = evaluate_expression(match.group(3).strip(), context)

    if "*" in object_name or "%" in object_name:
        names = _resolve_wildcard(object_name, context)
    else:
        names = [object_name]
    for name in names:
        context.setdefault(name, {})[property_name] = value


def _assign_variable(line: str, context: dict) -> None:
    match = re.fullmatch(VARIABLE_ASSIGNMENT, line)
    context[match.group(1).strip()] = evaluate_expression(
        match.group(2).strip(), context
    )


def _define_element(line: str, context: dict) -> None:
    match = re.fullmatch(ELEMENT_DEFINITION, line)
    element_name = match.group(1).strip('" ')
    element_type = match.group(2).strip()

    if element_type in context:
        # Inherit from a previously defined element (sub-typing).
        properties = deepcopy(context[element_type])
    else:
        properties = {"element_type": element_type}

    if match.group(3) is not None:
        property_pattern = (
            r"([a-z0-9_]+\s*\=\s*\"[^\"]+\"|[a-z0-9_]+\s*\=\s*[^\=\,\"]+)"
        )
        for assignment in re.findall(property_pattern, match.group(4).strip()):
            key, expression = assignment.split("=", 1)
            properties[key.strip()] = evaluate_expression(
                expression.strip(), context
            )

    context[element_name] = properties


def _define_line(line: str, context: dict) -> None:
    match = re.fullmatch(LINE_DEFINITION, line)
    line_name = match.group(1).strip('" ')
    context[line_name] = [
        element.strip('" ') for element in match.group(2).strip().split(",")
    ]


def _define_overlay(line: str, context: dict) -> None:
    knot_match = re.fullmatch(OVERLAY_KNOT, line)
    expression_match = re.fullmatch(OVERLAY_EXPRESSION, line)
    if knot_match:
        context[knot_match.group(1).strip()] = {
            "overlay_definition": knot_match.group(2).strip(),
            "overlay_variable": knot_match.group(3).strip(),
            "overlay_x_knot": knot_match.group(4).strip(),
        }
    elif expression_match:
        parameters = expression_match.group(4)
        context[expression_match.group(1).strip()] = {
            "overlay_definition": expression_match.group(2).strip(),
            "overlay_variables": expression_match.group(3).strip(),
            "overlay_parameters": (
                parameters.strip()[1:].strip() if parameters is not None else None
            ),
        }
    else:
        raise ValueError(f"Overlay definition {line} not understood.")


def parse_lines(lines: list[str]) -> dict:
    """Execute cleaned and merged lattice-file lines into a context dict."""
    context: dict = {
        "pi": scipy.constants.pi,
        "twopi": 2 * scipy.constants.pi,
        "c_light": scipy.constants.c,
        "emass": electron_mass_eV * 1e-9,  # In GeV
        "m_electron": electron_mass_eV,
        "sqrt": math.sqrt,
        "asin": math.asin,
        "sin": math.sin,
        "cos": math.cos,
        "abs_func": abs,
        "raddeg": scipy.constants.degree,
    }

    split_lines = [
        subline.strip()
        for line in lines
        for subline in line.split("#")[0].split(";")
    ]

    for line in split_lines:
        if re.fullmatch(PROPERTY_ASSIGNMENT, line):
            _assign_property(line, context)
        elif re.fullmatch(VARIABLE_ASSIGNMENT, line):
            _assign_variable(line, context)
        elif re.fullmatch(LINE_DEFINITION, line):
            _define_line(line, context)
        elif re.fullmatch(OVERLAY_DEFINITION, line):
            _define_overlay(line, context)
        elif re.fullmatch(ELEMENT_DEFINITION, line):
            _define_element(line, context)
        elif re.fullmatch(USE_LINE, line):
            context["__use__"] = re.fullmatch(USE_LINE, line).group(1).strip('" ')
        elif not line.strip() or line == "return":
            continue
        else:
            raise ValueError(
                f"Line '{line}' not understood. Please check the syntax and try "
                "again."
            )

    return context


def validate_understood_properties(understood: list[str], properties: dict) -> None:
    """Warn about properties that are not understood (so nothing is ignored
    silently)."""
    for name in properties:
        if not any(re.fullmatch(pattern, name) for pattern in understood):
            warnings.warn(
                f"Property {name} with value {properties[name]} for element "
                f"type {properties['element_type']} is currently not understood.",
                category=NotUnderstoodPropertyWarning,
                stacklevel=2,
            )
