"""A particle beam through its 7x7 map, and the moment sums of the outgoing
beam, in one operator call (``csrc/fused_transport.cu``).

Linear tracking of a :class:`~cheetah_tpu_torch.ParticleBeam` is
``particles @ map^T``; its readout (``sigma_x``, ``mu_y``, ...) needs the
survival-weighted sums of each outgoing component and of its square. In
PyTorch the sums read the outgoing beam twice and write its square as a
temporary of the beam's size. The operator
``cheetah_tpu_torch::transport_moments`` returns the outgoing particles
and both sums at once:

* on CUDA tensors, one launch of ``transport_moments_kernel``, which writes
  the outgoing beam once and takes the sums from the values it holds (a
  second, small launch adds the partial sums where one instance's particles
  span several blocks); each call counts as ``fused_transport`` in
  :func:`cheetah_tpu_torch.utils.profiling.counters`;
* on CPU tensors, its plain version: ``torch.matmul`` and the beam's own
  sums (:func:`~cheetah_tpu_torch.particles.particle_beam._weighted_sums`),
  so its results equal the unfused path's bit for bit; each call counts as
  ``fused_transport`` too;
* a fake rule gives its shapes, so ``torch.compile`` and ``torch.export``
  hold the transport as one opaque operator.

It has no derivative: :func:`takes` says whether it may run, which it may
only where nothing tracks a gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd import forward_ad
from torch.utils import flop_counter

from cheetah_tpu_torch.ops.cic_common import define_operator
from cheetah_tpu_torch.ops.fused_maps import _instance_stride
from cheetah_tpu_torch.ops.nvcc import CudaLibrary
from cheetah_tpu_torch.utils import profiling

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = CudaLibrary(
    "fused_transport.cu",
    {"transport_moments": [_P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _P, _P, _P, _P]},
)

#: Threads of a block (``kThreads`` in fused_transport.cu).
THREADS = 128
#: Blocks an SM should have to take at once, from which an instance's
#: particles are split into chunks when there are few instances.
_BLOCKS_PER_SM = 4
#: The sums of a block: 7 components and 7 squares.
_SUMS = 14


def _broadcast(*shapes: torch.Size) -> torch.Size:
    """``torch.broadcast_shapes`` of the shapes, without its host cost where
    they are equal or empty, as in the env step."""
    distinct = set(shapes) - {()}
    if len(distinct) <= 1:
        return distinct.pop() if distinct else torch.Size()
    return torch.broadcast_shapes(*distinct)


def _vector_shape(particles, transfer_map, weights) -> torch.Size:
    """The outgoing beam's vector shape; raises where the weights' do not
    broadcast into it or their particles are not the beam's."""
    try:
        shape = _broadcast(particles.shape[:-2], transfer_map.shape[:-2])
        fits = _broadcast(shape, weights.shape[:-1]) == shape
    except RuntimeError:
        fits = False
    if (not fits or particles.shape[-1] != 7 or transfer_map.shape[-2:] != (7, 7)
            or weights.shape[-1] != particles.shape[-2]):
        raise ValueError(
            f"particles {tuple(particles.shape)}, map {tuple(transfer_map.shape)} and weights "
            f"{tuple(weights.shape)} do not make one beam."
        )
    return shape


def takes(particles: torch.Tensor, transfer_map: torch.Tensor, weights: torch.Tensor) -> bool:
    """Whether the operator may transport these inputs: no tensor tracks a
    gradient (none ``requires_grad``; no transform of ``torch.func`` and no
    forward-mode level is active), all share one dtype, float32 or float64,
    and one device, the CPU or a card, and the weights' vector shape
    broadcasts into the outgoing beam's (as
    :func:`~cheetah_tpu_torch.ops.fused_maps.takes` decides for the maps)."""
    if torch._C._are_functorch_transforms_active() or forward_ad._current_level >= 0:
        return False
    dtype, device = particles.dtype, particles.device
    if dtype not in (torch.float32, torch.float64) or device.type not in ("cpu", "cuda"):
        return False
    for tensor in (particles, transfer_map, weights):
        if tensor.requires_grad or tensor.dtype != dtype or tensor.device != device:
            return False
    try:
        _vector_shape(particles, transfer_map, weights)
    except ValueError:
        return False
    return True


def _plain(particles, transfer_map, weights):
    """``transport_moments`` on CPU tensors: the matmul and the beam's sums."""
    from cheetah_tpu_torch.particles.particle_beam import _weighted_sums

    _vector_shape(particles, transfer_map, weights)
    out = torch.matmul(particles, transfer_map.transpose(-1, -2)).contiguous()
    s1, s2 = _weighted_sums(out, weights)
    profiling.count("fused_transport")
    return out, s1.contiguous(), s2.contiguous()


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_particles(instances: int, n: int, dtype: torch.dtype, sms: int) -> int:
    """The particles a block takes: all of an instance's (rounded up to the
    block's tile) where the instances fill the card, else a share of them
    such that about :data:`_BLOCKS_PER_SM` blocks an SM run."""
    tile = THREADS * (16 // dtype.itemsize)
    chunks = max(1, -(-_BLOCKS_PER_SM * sms // instances))
    return -(-(-(-n // chunks)) // tile) * tile


def _contiguous(shape, strides) -> bool:
    """Whether ``shape`` is laid out row-major at ``strides`` (a dimension
    of size 1 at any stride)."""
    expected = 1
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _operand(tensor, vector_shape, inner: int):
    """A tensor and the stride at which the kernel reads its instances, with
    its last ``inner`` dimensions contiguous; a tensor read otherwise is
    copied to that layout."""
    stride = None
    if _contiguous(tensor.shape[-inner:], tensor.stride()[-inner:]):
        stride = _instance_stride(tensor.shape[:-inner], tensor.stride()[:-inner], vector_shape)
    if stride is None:
        tensor = tensor.expand(*vector_shape, *tensor.shape[-inner:]).contiguous()
        stride = math.prod(tensor.shape[-inner:])
    return tensor, stride


def _kernel(particles, transfer_map, weights):
    """``transport_moments`` on CUDA tensors: one launch of
    ``transport_moments_kernel`` (and its sums pass where an instance spans
    several blocks), counted as ``fused_transport``."""
    vector_shape = _vector_shape(particles, transfer_map, weights)
    n = particles.shape[-2]
    out = particles.new_empty((*vector_shape, n, 7))
    s1 = particles.new_empty((*vector_shape, 7))
    s2 = particles.new_empty((*vector_shape, 7))
    instances = math.prod(vector_shape)
    if instances == 0:
        return out, s1, s2
    particles, particle_stride = _operand(particles, vector_shape, 2)
    transfer_map, map_stride = _operand(transfer_map, vector_shape, 2)
    weights, weight_stride = _operand(weights, vector_shape, 1)
    chunk = chunk_particles(instances, n, particles.dtype, _sms(particles.device))
    chunks = -(-n // chunk)
    partials = (torch.empty(instances * chunks * _SUMS, dtype=torch.float64,
                            device=particles.device) if chunks > 1 else None)
    LIBRARY.launch(
        "transport_moments", particles.dtype, particles.device,
        particles.data_ptr(), particle_stride, transfer_map.data_ptr(), map_stride,
        weights.data_ptr(), weight_stride, n, instances, chunk,
        out.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        None if partials is None else partials.data_ptr(),
    )
    profiling.count("fused_transport")
    return out, s1, s2


def _fake(particles, transfer_map, weights):
    vector_shape = _vector_shape(particles, transfer_map, weights)
    return (particles.new_empty((*vector_shape, particles.shape[-2], 7)),
            particles.new_empty((*vector_shape, 7)), particles.new_empty((*vector_shape, 7)))


#: ``cheetah_tpu_torch::transport_moments``: the outgoing particles
#: ``particles @ transfer_map^T``, ``(..., N, 7)``, and the weighted sums of
#: their components and of their squares, ``(..., 7)`` each.
TRANSPORT_MOMENTS = define_operator(
    "transport_moments",
    "(Tensor particles, Tensor transfer_map, Tensor weights) -> (Tensor, Tensor, Tensor)",
    _plain, _kernel, _fake,
)


def _flops(particles, transfer_map, weights, *args, out_shape=None, **kwargs) -> int:
    """The transport's product as ``torch.utils.flop_counter`` counts a
    matmul, ``2 * 7 * 7`` a particle. The sums, taken in the same pass from
    the values it holds, count none, as XLA's cost analysis of a tracking
    step counts none for a moment its caller does not read."""
    return 2 * 7 * math.prod(out_shape[0])


if TRANSPORT_MOMENTS.overloadpacket not in flop_counter.flop_registry:
    flop_counter.register_flop_formula(TRANSPORT_MOMENTS.overloadpacket)(_flops)
