"""Multi-order cloud-in-cell deposit and gather: CUDA kernels and their plain
PyTorch versions (counterpart of ``cheetah_tpu/ops/pallas_cic.py``).

The kernels are in ``cheetah_tpu_torch/csrc/cic.cu``; the note there says
which TPU kernel each one replaces and what bounds it on the card. The
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, into ``cheetah_tpu_torch/build/``, and loaded
with ``ctypes``.

Layouts are those of the JAX kernels, so the two packages compare like with
like:

- ``deposit_multi_3d(normalized (B, N, 3), rows (B, O, C, N), (nx, ny, nt),
  orders) -> (B, C, nx, ny, nt)``, summed over the orders;
- ``gather_multi_3d(grids (B, C, nx, ny, nt), normalized (B, N, 3), orders)
  -> O x (B, C, N)``.

``orders`` is a sequence of up to 8 per-axis derivative orders ``(ox, oy,
ot)`` in ``{0, 1}``: 0 is the hat weight, 1 its a.e. derivative. Positions
are in bin space: corner ``i0 = floor(p)`` weighs ``1 - f`` and ``i0 + 1``
weighs ``f``; corners off the grid, and every corner of a non-finite
position, weigh 0.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. There is no fallback from the
card to the plain version, and no bound on the grid size. Each wrapper
counts its kernel launches in a plain integer attribute ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Sequence

import torch

Orders = Sequence[tuple[int, int, int]]

#: The single value order, as the space-charge kick uses it.
VALUE = ((0, 0, 0),)

MAX_ORDERS = 8

_SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "cic.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_library: ctypes.CDLL | None = None
_library_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path() -> pathlib.Path:
    """Where the built library lives; the name carries a hash of the source
    and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libcic_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/cic.cu`` with nvcc unless the library exists already.

    :param verbose: Also ask ptxas for each kernel's registers and spills
        (``-Xptxas -v``) and print the compiler's output.
    """
    target = library_path()
    if target.exists() and not verbose:
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    command = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(_SOURCE)]
    result = subprocess.run(command, capture_output=True, text=True)
    if result.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({result.returncode}):\n{result.stdout}\n{result.stderr}"
        )
    if verbose:
        print(result.stdout + result.stderr, flush=True)
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _library
    with _library_lock:
        if _library is None:
            library = ctypes.CDLL(str(build()))
            pointer, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for name in (
                "cic_deposit_multi_f32",
                "cic_deposit_multi_f64",
                "cic_gather_multi_f32",
                "cic_gather_multi_f64",
            ):
                function = getattr(library, name)
                function.argtypes = [
                    pointer, pointer, pointer, i64, i64, i32, i32, i32, i32,
                    pointer, i32, pointer,
                ]
                function.restype = ctypes.c_int
            _library = library
        return _library


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_orders(orders: Orders) -> tuple[tuple[int, int, int], ...]:
    orders = tuple(tuple(int(v) for v in order) for order in orders)
    if not 1 <= len(orders) <= MAX_ORDERS:
        raise ValueError(f"Between 1 and {MAX_ORDERS} orders are supported: {orders}")
    if any(len(order) != 3 or any(v not in (0, 1) for v in order) for order in orders):
        raise ValueError(f"Orders must be (ox, oy, ot) triples of 0 and 1: {orders}")
    return orders


def _launch(name: str, dtype: torch.dtype, device: torch.device, tensors, sizes, orders):
    """Call the C entry point ``name`` for ``dtype`` on the current stream of
    ``device`` and raise if it reports a CUDA error."""
    if dtype not in _SUFFIX:
        raise TypeError(f"The CIC kernels take float32 or float64, not {dtype}.")
    function = getattr(_load(), f"{name}_{_SUFFIX[dtype]}")
    flat = (ctypes.c_int * (3 * len(orders)))(*(v for order in orders for v in order))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = function(
            *(tensor.data_ptr() for tensor in tensors),
            *sizes,
            ctypes.cast(flat, ctypes.c_void_p),
            len(orders),
            stream,
        )
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}.")


def _check_device(*tensors: torch.Tensor) -> str:
    device = tensors[0].device
    if any(tensor.device != device for tensor in tensors):
        raise ValueError("All inputs must lie on the same device.")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"Unsupported device {device}.")
    return device.type


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the kernels' yardstick.
# ---------------------------------------------------------------------------


def _axis_corners(position: torch.Tensor, num_bins: int):
    """Per axis: for corners 0 and 1, the clamped integer index, the validity
    mask and, for each order, the weight. Out-of-range and non-finite
    positions give invalid corners; the range is tested in floating point
    before any conversion to int."""
    floor = torch.floor(position)
    frac = position - floor
    corners = []
    for corner in (0, 1):
        index = floor + corner
        valid = (index >= 0) & (index <= num_bins - 1)
        index = torch.where(valid, index, torch.zeros_like(index)).long()
        weights = {
            0: frac if corner else 1.0 - frac,
            1: torch.full_like(frac, 1.0 if corner else -1.0),
        }
        corners.append((index, valid, weights))
    return corners


def _corner_terms(normalized: torch.Tensor, histogram_shape, orders):
    """For each of the 8 corners: the flat cell index ``(B, N)``, the
    validity mask ``(B, N)`` and one weight ``(B, N)`` per order."""
    nx, ny, nt = histogram_shape
    axes = [
        _axis_corners(normalized[..., axis], n)
        for axis, n in enumerate(histogram_shape)
    ]
    for cx in (0, 1):
        ix, vx, wx = axes[0][cx]
        for cy in (0, 1):
            iy, vy, wy = axes[1][cy]
            for ct in (0, 1):
                it, vt, wt = axes[2][ct]
                cell = (ix * ny + iy) * nt + it
                valid = vx & vy & vt
                weights = [wx[ox] * wy[oy] * wt[ot] for ox, oy, ot in orders]
                yield cell, valid, weights


def deposit_multi_3d_reference(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: Orders,
) -> torch.Tensor:
    """Plain version of :func:`deposit_multi_3d` with ``index_add_``."""
    orders = _check_orders(orders)
    batch, num_orders, num_components, num_particles = rows.shape
    cells = histogram_shape[0] * histogram_shape[1] * histogram_shape[2]
    out = torch.zeros(
        batch * num_components * cells, dtype=rows.dtype, device=rows.device
    )
    base = (
        torch.arange(batch * num_components, device=rows.device).view(
            batch, num_components, 1
        )
        * cells
    )
    for cell, valid, weights in _corner_terms(normalized, histogram_shape, orders):
        value = sum(rows[:, o] * weights[o][:, None, :] for o in range(num_orders))
        value = torch.where(valid[:, None, :], value, torch.zeros_like(value))
        index = base + cell[:, None, :]
        out.index_add_(0, index.reshape(-1), value.reshape(-1))
    return out.view(batch, num_components, *histogram_shape)


def gather_multi_3d_reference(
    grids: torch.Tensor, normalized: torch.Tensor, orders: Orders
) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`gather_multi_3d` with a flat ``gather``."""
    orders = _check_orders(orders)
    batch, num_components = grids.shape[:2]
    histogram_shape = tuple(grids.shape[2:])
    flat = grids.reshape(batch, num_components, -1)
    outs = [
        torch.zeros(
            batch, num_components, normalized.shape[1], dtype=grids.dtype,
            device=grids.device,
        )
        for _ in orders
    ]
    for cell, valid, weights in _corner_terms(normalized, histogram_shape, orders):
        index = cell[:, None, :].expand(batch, num_components, -1)
        value = torch.gather(flat, 2, index)
        for out, weight in zip(outs, weights):
            term = weight[:, None, :] * value
            out += torch.where(valid[:, None, :], term, torch.zeros_like(term))
    return tuple(outs)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def deposit_multi_3d(
    normalized: torch.Tensor,
    rows: torch.Tensor,
    histogram_shape: tuple[int, int, int],
    orders: Orders,
) -> torch.Tensor:
    """Multi-order CIC deposit: bin-space positions ``normalized (B, N, 3)``
    and per-order row blocks ``rows (B, O, C, N)`` -> the grid ``(B, C, nx,
    ny, nt)``, summed over the orders.

    CUDA tensors launch ``deposit_multi_kernel`` (atomic adds, so the sum
    order, and with it the last bits, change from run to run); CPU tensors
    run :func:`deposit_multi_3d_reference`.
    """
    orders = _check_orders(orders)
    histogram_shape = tuple(int(n) for n in histogram_shape)
    batch, num_orders, num_components, num_particles = rows.shape
    if normalized.shape != (batch, num_particles, 3) or num_orders != len(orders):
        raise ValueError(
            f"Shapes do not match: normalized {tuple(normalized.shape)}, rows "
            f"{tuple(rows.shape)}, {len(orders)} orders."
        )
    if len(histogram_shape) != 3 or min(histogram_shape) < 1:
        raise ValueError(f"A 3D grid shape is required: {histogram_shape}")
    if normalized.dtype != rows.dtype:
        raise TypeError(f"dtypes differ: {normalized.dtype} and {rows.dtype}")
    if _check_device(normalized, rows) == "cpu":
        return deposit_multi_3d_reference(normalized, rows, histogram_shape, orders)

    normalized = normalized.contiguous()
    rows = rows.contiguous()
    out = torch.zeros(
        (batch, num_components, *histogram_shape), dtype=rows.dtype, device=rows.device
    )
    if batch * num_particles * num_components == 0:
        return out
    _launch(
        "cic_deposit_multi",
        rows.dtype,
        rows.device,
        (normalized, rows, out),
        (batch, num_particles, num_components, *histogram_shape),
        orders,
    )
    deposit_multi_3d.launches += 1
    return out


deposit_multi_3d.launches = 0


def gather_multi_3d(
    grids: torch.Tensor, normalized: torch.Tensor, orders: Orders
) -> tuple[torch.Tensor, ...]:
    """Multi-order trilinear gather: ``grids (B, C, nx, ny, nt)`` and
    bin-space positions ``normalized (B, N, 3)`` -> one ``(B, C, N)`` tensor
    per order. The exact adjoint of :func:`deposit_multi_3d`.

    CUDA tensors launch ``gather_multi_kernel``; CPU tensors run
    :func:`gather_multi_3d_reference`.
    """
    orders = _check_orders(orders)
    if grids.dim() != 5:
        raise ValueError(f"grids must be (B, C, nx, ny, nt): {tuple(grids.shape)}")
    batch, num_components, nx, ny, nt = grids.shape
    num_particles = normalized.shape[1]
    if normalized.shape != (batch, num_particles, 3):
        raise ValueError(
            f"Shapes do not match: grids {tuple(grids.shape)}, normalized "
            f"{tuple(normalized.shape)}."
        )
    if normalized.dtype != grids.dtype:
        raise TypeError(f"dtypes differ: {grids.dtype} and {normalized.dtype}")
    if _check_device(grids, normalized) == "cpu":
        return gather_multi_3d_reference(grids, normalized, orders)

    grids = grids.contiguous()
    normalized = normalized.contiguous()
    out = torch.empty(
        (len(orders), batch, num_components, num_particles),
        dtype=grids.dtype,
        device=grids.device,
    )
    if batch * num_particles * num_components == 0:
        return tuple(out)
    _launch(
        "cic_gather_multi",
        grids.dtype,
        grids.device,
        (grids, normalized, out),
        (batch, num_particles, num_components, nx, ny, nt),
        orders,
    )
    gather_multi_3d.launches += 1
    return tuple(out)


gather_multi_3d.launches = 0
