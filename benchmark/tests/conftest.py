"""The benchmark's own tests (run by hand: ``python -m pytest
benchmark/tests -q``). ``card`` marks a test that needs the CUDA card; it
decides inside the test and skips on a host without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs the CUDA card; skips without one")
