"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference side imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BANNED = {"jax", "jaxlib", "flax", "raft_tpu"}
# The system adapters import the program (and controls.py, whose faults
# wrap it); everything else is the yardstick.
def program_side(p: Path) -> bool:
    return p.parent.name == "systems" or p.name == "controls.py"


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources():
    return [p for p in PKG.rglob("*.py") if "tests" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for p in sources():
        assert not set(imported_top_names(p)) & BANNED, p


def test_only_the_system_adapter_imports_the_program():
    for p in sources():
        names = set(imported_top_names(p))
        if program_side(p):
            continue
        assert "raft_tpu_torch" not in names, p


def test_names_compare_whole():
    from portbench.harness import banned_modules

    assert "raft_tpu_torch" not in BANNED
    sys.modules.setdefault("raft_tpu_torch_lookalike", sys)
    assert "raft_tpu_torch_lookalike" not in banned_modules()


def test_a_run_loads_no_banned_module():
    code = (
        "import time, json; from portbench import harness;"
        "r = harness.run_cell('raftrs-1m-r3.ycsb', 5, 0.3, False, t0=time.perf_counter(),"
        " device='cpu', n_groups=300);"
        "import sys; print(json.dumps([r['correct'], harness.banned_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules} & {'raft_tpu_torch'})]))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, banned, program = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert correct and banned == [] and program == ["raft_tpu_torch"]


def test_without_the_program_it_fails_and_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import time; from portbench import harness;"
            "harness.run_cell('raftrs-1m-r3.ycsb', 5, 0.3, False, t0=time.perf_counter(),"
            " device='cpu', n_groups=300)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "raft_tpu_torch" in out.stderr
