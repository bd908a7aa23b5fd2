"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests marked ``card`` run only where a CUDA device is present; the
``card`` fixture decides that when the test runs, never at import, so every
worker collects the same tests."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest portbench/tests -m card)")
    return "cuda"
