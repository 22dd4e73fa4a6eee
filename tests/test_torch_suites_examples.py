"""The port's micro-suites (raft_tpu_torch/benches/suites.py) and its three
scalar examples (raft_tpu_torch/examples/) on the CPU: the suites run with
--quick --device cpu and every multi-group suite runs at a small G; each
example runs as a module and ends with the reference example's success
line."""

import os
import subprocess
import sys

import pytest

from raft_tpu_torch.benches import suites

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_suites_quick_on_cpu(capsys):
    rows = suites.main(["--quick", "--device", "cpu"])
    names = [name for name, _, _ in rows]
    assert "Raft::new (3, 1)" in names and "Progress::new" in names
    assert "campaign (7,3) Transfer" in names
    assert names[-1] == "config2: 1k x 3 uniform"
    assert all(value > 0 for _, value, _ in rows)
    out = capsys.readouterr().out
    assert out.startswith("benchmark") and "config2: 1k x 3 uniform" in out


@pytest.mark.parametrize("fn,label", [
    (suites.bench_fused_instrumented, "config3i: 0k x 5 fused health+chaos"),
    (suites.bench_fused_damped, "config3cq: 0k x 5 fused health+ctrs+cq+pv"),
    (suites.bench_read_barrier, "read_index: 0k x 5 barrier"),
    (suites.bench_config4_reconfig_compiled, "config4: 0k x 5 compiled reconfig churn"),
    (suites.bench_config4_joint_churn, "config4: 0k x 5 joint churn"),
], ids=lambda v: getattr(v, "__name__", None))
def test_device_suites_at_small_g(fn, label):
    name, value, unit = fn(G=64, device="cpu")
    assert name == label and value > 0 and unit.startswith("M ")


def test_bench_delegating_suites():
    """config4f and config3r run the bench's own prod-fused and reads modes;
    the labels carry the measured fused fraction (and the read p99)."""
    name, value, _ = suites.bench_prod_fused_split(G=32, device="cpu")
    assert name.startswith("config4f: 0k x 5 split-fused prod churn (fused_frac ")
    name, value, _ = suites.bench_reads_workload(G=32, device="cpu")
    assert name.startswith("config3r: 0k x 5 zipf read/write mix (fused_frac ")
    assert value > 0


def test_baseline_config_is_the_plain_step():
    name, value, unit = suites.baseline_config("config3: 100k x 5 zipf", 64, 5,
                                               "zipf", "cpu", rounds=10)
    assert name == "config3: 100k x 5 zipf" and value > 0 and unit == "M ticks/s"


@pytest.mark.parametrize("module,line", [
    ("single_mem_node", "single_mem_node OK"),
    ("five_mem_node", "five_mem_node OK"),
    ("tcp_cluster", "tcp_cluster OK: 20 entries replicated over TCP to 3 processes"),
])
def test_scalar_examples(module, line):
    res = subprocess.run(
        [sys.executable, "-m", f"raft_tpu_torch.examples.{module}"],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.rstrip().splitlines()[-1] == line
