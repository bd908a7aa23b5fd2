"""Device and dtype resolution for tensors built from Python values.

The port runs on the GPU unless the caller asks for the CPU: every entry
point that builds tensors from Python numbers resolves ``device=None`` to
``"cuda"`` and raises when no card is present, so a missing card is never
hidden by a silent CPU run. Tensors that are passed in keep their device; a
tensor on another device than the one requested raises instead of being
moved.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily


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


def is_transformed(tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` is wrapped by a ``torch.func`` transform (vmap,
    grad, jvp), whose values cannot be read on the host."""
    return torch._C._functorch.is_functorch_wrapped_tensor(tensor)


def check_module_device(module: torch.nn.Module, device: torch.device) -> None:
    """Raise if any buffer of ``module`` lies on another device than ``device``.

    A 0-dimensional CPU tensor combines silently with CUDA tensors in
    PyTorch, so a lattice left on the CPU would otherwise mix into a GPU run
    without an error. The walk over the buffers reads devices alone, so under
    ``torch.compile`` it runs while the step is traced (the buffers' devices
    are guarded there) and leaves nothing in the compiled program.
    """
    for name, buffer in _named_buffers(module):
        if not same_device(buffer.device, device):
            raise ValueError(
                f"{type(module).__name__} parameter {name!r} is on device "
                f"{buffer.device} but the beam is on device {device}; move one "
                "of them explicitly with .to()."
            )


def _named_buffers(module: torch.nn.Module, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``module.named_buffers()`` without its set of visited modules, which
    hashes the modules and so cannot be traced; a module reached twice is
    listed twice."""
    named = [(prefix + name, buffer) for name, buffer in module._buffers.items()
             if buffer is not None]
    for name, child in module._modules.items():
        if child is not None:
            named += _named_buffers(child, f"{prefix}{name}.")
    return named


def constant_cache(function: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``functools.lru_cache`` for a function that builds a constant tensor
    from hashable arguments (an index, an identity, a grid's counts), made
    once per device instead of copied from the host on every call.

    The tensor is built outside any fake-tensor mode: ``torch.export``
    traces with fake tensors, and a fake tensor cached during a trace would
    be handed to every later call, eager or traced. A real constant is
    carried into the exported program as one of its constants. Under
    ``torch.compile`` the constant is built in the traced program instead,
    which the compiler folds: the cache is the eager path's saving of a copy
    from the host, and a compiled program makes no such copy. Inside a
    transform of ``torch.func`` it is built anew too: a tensor made there is
    the transform's wrapper, whose storage is gone once the transform ends.
    """
    cached = functools.lru_cache(maxsize=None)(function)

    @functools.wraps(function)
    def build_once(*args):
        if torch.compiler.is_compiling() or torch._C._are_functorch_transforms_active():
            return function(*args)
        with unset_fake_temporarily():
            return cached(*args)

    build_once.cache_clear = cached.cache_clear
    return build_once
