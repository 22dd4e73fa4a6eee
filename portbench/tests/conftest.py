"""The benchmark's own tests: `python3 -m pytest portbench/tests -q` from the
checkout's root.  Tests marked `cuda` need a card and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark under tmp_path, extended by new files alone:
    extend(files={relative path: text}, configs=[...], workloads=[...],
    per_layer=[...]) writes the files under portbench/ and appends the
    entries to the copy's BENCHMARK.json; returns the copy's root."""
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    def extend(files=(), configs=(), workloads=(), per_layer=()):
        for rel, text in dict(files).items():
            path = tmp_path / "portbench" / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
        bench["configs"].extend(configs)
        bench["workloads"].extend(workloads)
        bench["per_layer"].extend(per_layer)
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        return tmp_path

    return extend
