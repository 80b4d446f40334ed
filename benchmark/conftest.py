"""pytest set-up for the benchmark's own tests: the benchmark's folder on
the import path (the harness and the reference import as top-level
packages, as ``python3 benchmark/run.py`` finds them) before the root of
the checkout (the port's package), and the ``cuda``
marker for tests that need the card."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a machine without one")
