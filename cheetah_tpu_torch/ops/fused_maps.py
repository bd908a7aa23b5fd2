"""The map of a fused linear run in one operator call (``csrc/fused_maps.cu``).

A fused run's map is ``M_{n-1} @ ... @ M_0 @ I`` over its elements'
first-order maps. Built element by element (the composite,
``Segment.first_order_transfer_map``'s loop) it takes about 15 small
operators an element, each a kernel launch and 12-15 us of the host's time
on the card. The operator ``cheetah_tpu_torch::fused_run_map`` builds it
from the elements' parameters instead:

* on CUDA tensors, one launch of ``fused_run_map_kernel`` per
  :data:`MAX_ENTRIES` elements (a longer run chains launches, each starting
  from the product the last wrote), counted as ``fused_run_map`` in
  :func:`cheetah_tpu_torch.utils.profiling.counters`;
* on CPU tensors, its plain version: the composite itself, from the same
  builders (``ops/transfer_maps.py``) the elements call, so its maps equal
  the composite's bit for bit;
* a fake rule gives its shape, so ``torch.compile`` and ``torch.export``
  hold the run as one opaque operator.

The operator takes the run as opcodes (one per element, of the kinds
below) and a flat list of the elements' parameters in the order
:data:`KINDS` gives. It has no derivative: :func:`takes` says whether
it may build a map, which it may only where nothing tracks a gradient.
"""

from __future__ import annotations

import array
import ctypes
import math
import types
from typing import Callable, NamedTuple

import torch
from torch.autograd import forward_ad
from torch.utils import flop_counter

from cheetah_tpu_torch.ops.cic_common import define_operator
from cheetah_tpu_torch.ops.nvcc import CudaLibrary
from cheetah_tpu_torch.ops.transfer_maps import (
    corrector_matrix,
    drift_matrix,
    identity_transfer_map,
    quadrupole_matrix,
)
from cheetah_tpu_torch.utils import profiling

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = CudaLibrary("fused_maps.cu", {"fused_run_map": [_P, _I64, _P, _P, _P]})

#: The opcodes (``Opcode`` in fused_maps.cu).
MARKER, DRIFT, QUADRUPOLE, HORIZONTAL_CORRECTOR, VERTICAL_CORRECTOR, COMBINED_CORRECTOR = range(6)


class Kind(NamedTuple):
    """An element kind the operator takes: the element's attributes it
    reads, in order; which of them carry a trailing pair (a misalignment,
    ``(..., 2)``); and the builder of its map from them, with the functions
    of ``ops/transfer_maps.py`` that the element's own
    ``first_order_transfer_map`` calls."""

    attributes: tuple[str, ...]
    pairs: tuple[bool, ...]
    build: Callable[..., torch.Tensor]


#: Each opcode's kind. An element class that the operator takes names its
#: opcode as its own ``fused_opcode``.
KINDS = {
    MARKER: Kind((), (), lambda energy, species: identity_transfer_map(energy)),
    DRIFT: Kind(("length",), (False,), drift_matrix),
    QUADRUPOLE: Kind(
        ("length", "k1", "misalignment", "tilt"), (False, False, True, False), quadrupole_matrix
    ),
    HORIZONTAL_CORRECTOR: Kind(
        ("length", "angle"), (False, False),
        lambda length, angle, energy, species: corrector_matrix(
            length, energy, species, {1: angle}),
    ),
    VERTICAL_CORRECTOR: Kind(
        ("length", "angle"), (False, False),
        lambda length, angle, energy, species: corrector_matrix(
            length, energy, species, {3: angle}),
    ),
    COMBINED_CORRECTOR: Kind(
        ("length", "horizontal_angle", "vertical_angle"), (False, False, False),
        lambda length, horizontal, vertical, energy, species: corrector_matrix(
            length, energy, species, {1: horizontal, 3: vertical}),
    ),
}

#: Elements one launch takes (``kMaxEntries`` in fused_maps.cu).
MAX_ENTRIES = 32
#: Parameter slots of a table entry (``kSlots``): a pair takes two.
_SLOTS = 5


def takes(parameters: list[torch.Tensor], energy: torch.Tensor, mass: torch.Tensor) -> bool:
    """Whether the operator may build the map of these inputs: no tensor
    tracks a gradient (none ``requires_grad``; no transform of
    ``torch.func`` and no forward-mode level is active, inside which a
    tensor may be differentiated or batched without showing it to the
    compiler), and every tensor has the energy's dtype, float32 or float64,
    and its device, the CPU or a card."""
    if torch._C._are_functorch_transforms_active() or forward_ad._current_level >= 0:
        return False
    dtype, device = energy.dtype, energy.device
    if dtype not in (torch.float32, torch.float64) or device.type not in ("cpu", "cuda"):
        return False
    for tensor in (energy, mass, *parameters):
        if tensor.requires_grad or tensor.dtype != dtype or tensor.device != device:
            return False
    return True


def _split(parameters, opcodes) -> list:
    """Each element's parameters; raises where their number does not match
    the opcodes' or where there is no element."""
    taken = sum(len(KINDS[opcode].pairs) for opcode in opcodes)
    if not opcodes or taken != len(parameters):
        raise ValueError(f"{len(parameters)} parameters for {len(opcodes)} opcodes taking {taken}.")
    position, split = 0, []
    for opcode in opcodes:
        split.append(parameters[position : position + len(KINDS[opcode].pairs)])
        position += len(KINDS[opcode].pairs)
    return split


def _vector_shapes(split, energy, mass, opcodes) -> list:
    """The energy's, the parameters' and (where an element reads it) the
    mass's vector shapes, which the composite broadcasts."""
    shapes = [energy.shape]
    if any(opcode != MARKER for opcode in opcodes):
        shapes.append(mass.shape)
    for opcode, arguments in zip(opcodes, split):
        for pair, argument in zip(KINDS[opcode].pairs, arguments):
            shapes.append(argument.shape[:-1] if pair else argument.shape)
    return shapes


def _vector_shape(parameters, energy, mass, opcodes) -> torch.Size:
    return torch.broadcast_shapes(
        *_vector_shapes(_split(parameters, opcodes), energy, mass, opcodes)
    )


def _plain(parameters, energy, mass, opcodes) -> torch.Tensor:
    """``fused_run_map`` on CPU tensors: the composite, element by element."""
    species = types.SimpleNamespace(mass_eV=mass)
    tm = torch.eye(7, dtype=energy.dtype, device=energy.device)
    for opcode, arguments in zip(opcodes, _split(parameters, opcodes)):
        tm = KINDS[opcode].build(*arguments, energy, species) @ tm
    return tm


def _instance_stride(shape, strides, vector_shape) -> int | None:
    """The stride at which a tensor of ``shape`` and ``strides``, broadcast
    to ``vector_shape``, is read over the flattened instance index; ``None``
    where no single stride reads it (a broadcast inside a dimension it
    has)."""
    lead = len(vector_shape) - len(shape)
    stride, inner = None, 1
    for axis in range(len(vector_shape) - 1, -1, -1):
        size = vector_shape[axis]
        if size == 1:
            continue
        own = axis - lead
        step = strides[own] if own >= 0 and shape[own] != 1 else 0
        if stride is None:
            stride = step
        elif step != stride * inner:
            return None
        inner *= size
    return stride or 0


def _slots(tensor, pair, vector_shape, keep) -> list[int]:
    """A parameter's table words: address and stride, for a pair both
    components'. A tensor no single stride reads is copied in full (kept in
    ``keep`` until the launch)."""
    if tensor.dim() == 0:
        return [tensor.data_ptr(), 0]
    shape, strides = tensor.shape, tensor.stride()
    if pair:
        shape, strides = shape[:-1], strides[:-1]
    stride = _instance_stride(shape, strides, vector_shape)
    if stride is None:
        tensor = tensor.expand(*vector_shape, *tensor.shape[len(shape):]).contiguous()
        keep.append(tensor)
        stride = 2 if pair else 1
    address = tensor.data_ptr()
    if not pair:
        return [address, stride]
    return [address, stride, address + tensor.stride(-1) * tensor.element_size(), stride]


def _kernel(parameters, energy, mass, opcodes) -> torch.Tensor:
    """``fused_run_map`` on CUDA tensors: ``fused_run_map_kernel``, one
    launch per :data:`MAX_ENTRIES` elements, each counted as
    ``fused_run_map``."""
    device, dtype = energy.device, energy.dtype
    split = _split(parameters, opcodes)
    # Most runs broadcast one shape against 0-d tensors: that is read off
    # without torch.broadcast_shapes, which costs tens of us on the host.
    shapes = set(_vector_shapes(split, energy, mass, opcodes)) - {()}
    vector_shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(*shapes)
    out = torch.empty((*vector_shape, 7, 7), dtype=dtype, device=device)
    instances = out.numel() // 49
    if instances == 0:
        return out
    keep: list[torch.Tensor] = []
    # A run of markers alone reads no mass, whose shape may then not
    # broadcast; the kernel divides the energy by itself instead.
    reads_mass = any(opcode != MARKER for opcode in opcodes)
    header = _slots(energy, 0, vector_shape, keep)
    header += _slots(mass if reads_mass else energy, 0, vector_shape, keep)
    entries = []
    for opcode, arguments in zip(opcodes, split):
        words = [opcode]
        for pair, argument in zip(KINDS[opcode].pairs, arguments):
            words += _slots(argument, pair, vector_shape, keep)
        entries.append(words + [0] * (1 + 2 * _SLOTS - len(words)))
    for start in range(0, len(entries), MAX_ENTRIES):
        chunk = entries[start : start + MAX_ENTRIES]
        table = array.array("q", header + [len(chunk)] + [word for e in chunk for word in e])
        LIBRARY.launch(
            "fused_run_map", dtype, device, table.buffer_info()[0], instances,
            out.data_ptr() if start else None, out.data_ptr(),
        )
        profiling.count("fused_run_map")
    return out


def _fake(parameters, energy, mass, opcodes) -> torch.Tensor:
    return energy.new_empty((*_vector_shape(parameters, energy, mass, opcodes), 7, 7))


#: ``cheetah_tpu_torch::fused_run_map``: the ``(..., 7, 7)`` map of a
#: fused linear run from its opcodes and their parameters.
FUSED_RUN_MAP = define_operator(
    "fused_run_map",
    "(Tensor[] parameters, Tensor energy, Tensor mass, int[] opcodes) -> Tensor",
    _plain, _kernel, _fake,
)


def _flops(parameters, energy, mass, opcodes, *args, out_shape=None, **kwargs) -> int:
    """The 7x7 products of the plain version for every instance, as
    ``torch.utils.flop_counter`` counts them (2 * 7^3 each): one an element,
    three a quadrupole (its frames)."""
    products = sum(3 if opcode == QUADRUPOLE else 1 for opcode in opcodes)
    return 2 * 7**3 * products * math.prod(out_shape[:-2])


if FUSED_RUN_MAP.overloadpacket not in flop_counter.flop_registry:
    flop_counter.register_flop_formula(FUSED_RUN_MAP.overloadpacket)(_flops)
