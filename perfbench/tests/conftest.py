"""The benchmark's own tests: ``python3 -m pytest perfbench/tests`` from the
checkout's root.  Tests marked ``card`` need an NVIDIA card and skip
without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")

