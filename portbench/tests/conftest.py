"""The benchmark's own tests: `python3 -m pytest portbench/tests -q` from the
checkout's root.  Tests marked `cuda` need a card and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
