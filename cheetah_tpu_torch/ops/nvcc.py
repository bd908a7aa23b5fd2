"""Build and load the port's CUDA sources (``cheetah_tpu_torch/csrc``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``cheetah_tpu_torch/build/``,
and loaded with ``ctypes``. The library's file name carries a hash of the
source, the headers of ``csrc`` and the flags, so an edited source is
rebuilt. :func:`build_all` starts one ``nvcc`` per source, all at once.
Nothing is compiled or loaded at import.
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

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


class CudaLibrary:
    """One CUDA source and the C entry points it exports.

    :param source: File name under ``csrc/``.
    :param functions: Entry point name -> ctypes argument types. Each entry
        point exists as ``<name>_f32`` and ``<name>_f64`` and returns
        ``cudaGetLastError()`` as an int.
    :param untyped: Entry points of one name, called with :meth:`call`:
        name -> ctypes argument types; each returns a CUDA error code.
    """

    def __init__(
        self, source: str, functions: dict[str, list], untyped: dict[str, list] | None = None
    ) -> None:
        self.source = CSRC_DIR / source
        self.functions = functions
        self.untyped = untyped or {}
        self.handle: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self._entries: dict = {}

    def path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def build(self, verbose: bool = False) -> pathlib.Path:
        """Compile the source unless the library exists already."""
        build_all([self], verbose)
        return self.path()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self.handle is None:
                library = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.functions.items():
                    for suffix in _SUFFIX.values():
                        function = getattr(library, f"{name}_{suffix}")
                        function.argtypes = argtypes
                        function.restype = ctypes.c_int
                for name, argtypes in self.untyped.items():
                    function = getattr(library, name)
                    function.argtypes = argtypes
                    function.restype = ctypes.c_int
                self.handle = library
            return self.handle

    def launch(self, name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
        """Call the entry point ``name`` for ``dtype`` on the current stream
        of ``device`` (appended as the last argument) and raise if it reports
        a CUDA error. The host's time per call counts on paths of many small
        launches, so the entry point is looked up once, the stream is read
        as a raw handle (``torch.cuda.current_stream`` builds a Python object
        each call), and the device is switched only when it is not the
        current one."""
        function = self._entries.get((name, dtype))
        if function is None:
            if dtype not in _SUFFIX:
                raise TypeError(f"The kernels take float32 or float64, not {dtype}.")
            function = getattr(self.load(), f"{name}_{_SUFFIX[dtype]}")
            self._entries[(name, dtype)] = function
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            status = function(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                status = function(*args, torch._C._cuda_getCurrentRawStream(index))
        if status != 0:
            raise RuntimeError(f"{name} launch failed with CUDA error {status}.")


    def call(self, name: str, *args) -> None:
        """Call the untyped entry point ``name`` and raise if it reports a
        CUDA error."""
        status = getattr(self.load(), name)(*args)
        if status != 0:
            raise RuntimeError(f"{name} failed with CUDA error {status}.")


def build_all(libraries: list[CudaLibrary], verbose: bool = False) -> dict[str, str]:
    """Compile every library that is not built yet, one ``nvcc`` process per
    source, all started together.

    :param verbose: Build even libraries that exist, and also ask ptxas for
        each kernel's registers and spills (``-Xptxas -v``).
    :return: The compiler's output for each source built, by file name.
    """
    jobs = []
    for library in libraries:
        target = library.path()
        if target.exists() and not verbose:
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        command = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, str(library.source)]
        process = subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((library, target, tmp, process))
    failures = []
    outputs = {}
    for library, target, tmp, process in jobs:
        output, _ = process.communicate()
        if process.returncode != 0:
            os.unlink(tmp)
            failures.append(
                f"nvcc failed on {library.source.name} ({process.returncode}):\n{output}"
            )
            continue
        outputs[library.source.name] = output
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outputs
