"""Guards of the PyTorch port as a package: it imports neither JAX nor the
JAX package, its entry points refuse to run on the CPU unless asked, and its
kernel wrappers take the plain versions for CPU tensors only."""

import ast
import pathlib
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.lattices import ares_ea_subcell
from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "cheetah_tpu_torch"


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def test_no_jax_or_jax_package_imports():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "cheetah_tpu"), f"{path}: imports {name}"


def test_import_loads_neither_jax_nor_triton():
    """Importing the port (and building a lattice on the CPU) pulls in no JAX,
    and no kernel is compiled or loaded at import."""
    code = (
        "import sys, torch, cheetah_tpu_torch as ctt;"
        "from cheetah_tpu_torch.ops import cic_kernels, cic_tiled;"
        "ctt.lattices.ares_ea_subcell(device='cpu');"
        "assert not any(m.split('.')[0] in ('jax', 'cheetah_tpu', 'triton') for m in sys.modules);"
        "assert cic_kernels.LIBRARY.handle is None and cic_tiled.LIBRARY.handle is None"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_entry_points_raise_without_a_card():
    """device=None means the GPU; with no card that must fail loudly rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctt.ParticleBeam.from_twiss(num_particles=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ares_ea_subcell()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctt.Drift(0.5)
    assert ares_ea_subcell(device="cpu").AREAMQZM1.k1.device.type == "cpu"


def test_wrappers_use_plain_versions_for_cpu_tensors():
    rng = np.random.default_rng(20)
    shape = (4, 5, 3)
    normalized = torch.from_numpy(
        rng.uniform(-1, 5, size=(2, 30, 3)).astype(np.float32)
    )
    rows = torch.from_numpy(rng.normal(size=(2, 2, 3, 30)).astype(np.float32))
    grids = torch.from_numpy(rng.normal(size=(2, 3, *shape)).astype(np.float32))
    orders = ((0, 0, 0), (1, 0, 1))
    deposits = cic_kernels.deposit_multi_3d.launches
    gathers = cic_kernels.gather_multi_3d.launches

    grid = cic_kernels.deposit_multi_3d(normalized, rows, shape, orders)
    values = cic_kernels.gather_multi_3d(grids, normalized, orders)

    assert cic_kernels.deposit_multi_3d.launches == deposits
    assert cic_kernels.gather_multi_3d.launches == gathers
    assert torch.equal(
        grid, cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, orders)
    )
    for got, want in zip(values, cic_kernels.gather_multi_3d_reference(grids, normalized, orders)):
        assert torch.equal(got, want)
    assert cic_kernels.LIBRARY.handle is None


def test_wrappers_reject_bad_arguments():
    # Explicit dtypes: other test modules set torch's default dtype to float64.
    f32 = {"dtype": torch.float32}
    normalized = torch.zeros(1, 5, 3, **f32)
    with pytest.raises(ValueError, match="orders"):
        cic_kernels.deposit_multi_3d(normalized, torch.zeros(1, 9, 1, 5, **f32), (4, 4, 4),
                                     [(0, 0, 0)] * 9)
    with pytest.raises(ValueError, match="triples"):
        cic_kernels.gather_multi_3d(torch.zeros(1, 1, 4, 4, 4, **f32), normalized, [(2, 0, 0)])
    with pytest.raises(ValueError, match="Shapes"):
        cic_kernels.deposit_multi_3d(normalized, torch.zeros(1, 1, 1, 6, **f32), (4, 4, 4),
                                     cic_kernels.VALUE)
    with pytest.raises(TypeError, match="dtypes"):
        cic_kernels.gather_multi_3d(torch.zeros(1, 1, 4, 4, 4, dtype=torch.float64),
                                    normalized, cic_kernels.VALUE)


def test_kernel_sources_are_packaged_and_built_outside_git():
    with open(REPO / "pyproject.toml", "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert "csrc/*.cu" in package_data["cheetah_tpu_torch"]
    assert (PACKAGE / "csrc" / "cic.cu").is_file()
    assert (PACKAGE / "csrc" / "cic_tiled.cu").is_file()
    for built in (cic_kernels.LIBRARY.path(), cic_tiled.LIBRARY.path()):
        assert built.parent.name == "build" and built.parent.parent == PACKAGE
    assert "build/" in (REPO / ".gitignore").read_text().split()
