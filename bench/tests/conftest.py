"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
repository root.  Tests marked ``card`` need a CUDA device; each decides
inside itself whether one is present and skips otherwise."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
