"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
``cheetah_tpu_torch`` begins with ``cheetah_tpu``)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "cheetah_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert imported_names_clash({"cheetah_tpu_torch"}) == set()
    assert imported_names_clash({"cheetah_tpu", "jax"}) == {"cheetah_tpu", "jax"}


def imported_names_clash(names: set) -> set:
    return names & BANNED


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert imported_names_clash(imported(path)) == set()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "cheetah_tpu_torch" not in imported(path)


def test_run_checks_loaded_modules_by_whole_names(monkeypatch):
    import sys
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "cheetah_tpu_torch_like", types.ModuleType("x"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.banned_modules() == ["jax"]
