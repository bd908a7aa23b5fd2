"""Device and dtype resolution for tensors built from Python values.

The port runs on the GPU unless the caller asks for the CPU: every entry
point that builds tensors from Python numbers resolves ``device=None`` to
``"cuda"`` and raises when no card is present, so a missing card is never
hidden by a silent CPU run. Tensors that are passed in keep their device; a
tensor on another device than the one requested raises instead of being
moved.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``"cuda"`` when ``None``.

    :raises RuntimeError: if the device is a CUDA device and no card is
        available.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cheetah_tpu_torch runs on the GPU by default, but CUDA is not "
            "available. Pass device='cpu' to run on the CPU."
        )
    return device


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality that treats an unindexed ``cuda`` as the current card."""
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


def as_float_tensor(
    value: Any,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``torch.as_tensor`` for physical parameters.

    Integer and boolean values become the default float dtype (an integer
    transfer map would truncate silently). A tensor keeps its device;
    ``device`` only checks it. Python values go to ``device`` (``"cuda"``
    when ``None``).

    :raises ValueError: if a tensor lies on another device than ``device``.
    """
    if isinstance(value, torch.Tensor):
        if device is not None and not same_device(value.device, torch.device(device)):
            raise ValueError(
                f"Tensor on device {value.device} given where device {device} "
                "is required; move it explicitly with .to()."
            )
        tensor = value if dtype is None else value.to(dtype)
    else:
        tensor = torch.as_tensor(value, dtype=dtype, device=resolve_device(device))
    if not tensor.is_floating_point():
        tensor = tensor.to(torch.get_default_dtype())
    return tensor


def infer_dtype_device(
    values: Iterable[Any],
    dtype: torch.dtype | None,
    device: torch.device | str | None,
) -> tuple[torch.dtype, torch.device]:
    """The dtype and device for a constructor: those given, else those of the
    first tensor among ``values``, else the default dtype and the GPU."""
    for value in values:
        if isinstance(value, torch.Tensor):
            if dtype is None and value.is_floating_point():
                dtype = value.dtype
            if device is None:
                device = value.device
            break
    dtype = dtype if dtype is not None else torch.get_default_dtype()
    return dtype, resolve_device(device)


def check_module_device(module: torch.nn.Module, device: torch.device) -> None:
    """Raise if any buffer of ``module`` lies on another device than ``device``.

    A 0-dimensional CPU tensor combines silently with CUDA tensors in
    PyTorch, so a lattice left on the CPU would otherwise mix into a GPU run
    without an error.
    """
    for name, buffer in module.named_buffers():
        if not same_device(buffer.device, device):
            raise ValueError(
                f"{type(module).__name__} parameter {name!r} is on device "
                f"{buffer.device} but the beam is on device {device}; move one "
                "of them explicitly with .to()."
            )
