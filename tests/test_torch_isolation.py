"""The PyTorch port stands alone: no module of `raft_tpu_torch`, and not
`chip_smoke.py`, imports jax, jaxlib or anything of the JAX package
`raft_tpu` (the name is a prefix of the port's own, so the check is on whole
dotted names)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "raft_tpu")


def _sources():
    files = sorted((ROOT / "raft_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value)


def test_every_multiraft_module_is_scanned():
    """The AST scan covers the registries, the unified runner, the
    checkpoint, the graph helper and the host driver with the rest of the
    package, and the scalar copies and the node examples the driver runs."""
    names = {p.stem for p in _sources() if p.parent.name == "multiraft"}
    assert {"planes", "schedules", "runner", "checkpoint", "graphs", "sim",
            "driver"} <= names
    scalar = {p.stem for p in _sources() if p.parent.name == "scalar"}
    assert {"raw_node", "status", "metrics", "codec"} <= scalar
    examples = {p.stem for p in _sources() if p.parent.name == "examples"}
    assert {"multiraft_node", "multiraft_tcp"} <= examples


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_whole_names():
    assert _forbidden("raft_tpu.multiraft.sim") and _forbidden("jax.numpy")
    assert not _forbidden("raft_tpu_torch.multiraft.sim")


def test_importing_the_port_loads_no_reference_module():
    """Import the package and every submodule in a fresh interpreter; no
    `raft_tpu`/`raft_tpu.*` module may appear.  A sitecustomize may import
    jax before us, so only modules new since start-up count for jax."""
    mods = sorted(
        "raft_tpu_torch." + ".".join(p.relative_to(ROOT / "raft_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "raft_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        "import raft_tpu_torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print(json.dumps(new))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    new = json.loads(res.stdout.strip().splitlines()[-1])
    assert "raft_tpu_torch.multiraft.steady_kernel" in new
    assert "raft_tpu_torch.multiraft.chaos_kernel" in new
    assert "raft_tpu_torch.multiraft.chaos" in new
    assert "raft_tpu_torch.multiraft.reconfig" in new
    for mod in ("planes", "schedules", "runner", "checkpoint", "graphs", "driver"):
        assert "raft_tpu_torch.multiraft." + mod in new
    for mod in ("multiraft_node", "multiraft_tcp"):
        assert "raft_tpu_torch.examples." + mod in new
    for sub in ("eraftpb", "errors", "util", "confchange.changer",
                "confchange.restore", "quorum.joint", "quorum.majority",
                "tracker.inflights", "tracker.progress", "tracker.state",
                "raw_node", "status", "metrics", "codec"):
        assert "raft_tpu_torch.scalar." + sub in new
    bad = [m for m in new if _forbidden(m)]
    assert not bad, bad
