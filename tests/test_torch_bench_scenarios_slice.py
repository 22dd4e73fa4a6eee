"""The port's bench against the repository's `bench.py` on --lossy
--check-quorum (the per-group hybrid split; marked slow, see its test) and
the scenario modes: --chaos and --reconfig (each with and without
--check-quorum), --prod-fused, --reads and --autopilot (the bench's own
plan, and examples/chaos/partition_heal.json through --autopilot-plan, the
repository plan under which the autopilot's transfer arm acts), at G = 32,
one rep, on the CPU.  The lines must be equal on every field not derived
from time (the reports, the actions, the read percentiles, the safety
counts, the segments and the fused counts), and so must each mode's
--*-out report file."""

import json
from pathlib import Path

import pytest

from test_torch_bench_slice import assert_same_line, port_line, reference_line

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CHAOS = str(EXAMPLES / "chaos" / "partition_heal.json")
RECONFIG = str(EXAMPLES / "reconfig" / "joint_churn.json")
PROD = str(EXAMPLES / "reconfig" / "prod_fused.json")
READS = str(EXAMPLES / "reads" / "zipf_mixed.json")


@pytest.mark.slow
def test_composed_hybrid(capsys, monkeypatch):
    """--lossy 0.01 --check-quorum, the per-group hybrid split: about a
    minute serial, most of it the reference's hybrid dispatcher compiled in
    interpret mode, which would carry this file past its 200 s."""
    argv = ["--lossy", "0.01", "--check-quorum"]
    ref = reference_line(argv, capsys, monkeypatch)
    ours = port_line(argv, capsys)
    assert_same_line(ours, ref)
    assert 0 < ours["fused_rounds"] < ours["total_rounds"]


@pytest.mark.parametrize("mode,plan,out_flag,cq", [
    ("--chaos", CHAOS, "--chaos-out", False),
    ("--chaos", CHAOS, "--chaos-out", True),
    ("--reconfig", RECONFIG, "--reconfig-out", False),
    ("--reconfig", RECONFIG, "--reconfig-out", True),
    ("--prod-fused", PROD, "--prod-out", False),
    ("--reads", READS, "--reads-out", False),
], ids=["chaos", "chaos-cq", "reconfig", "reconfig-cq", "prod-fused", "reads"])
def test_scenario_modes(mode, plan, out_flag, cq, capsys, monkeypatch, tmp_path):
    """--prod-fused and --reads run check-quorum and pre-vote always."""
    argv = [mode, plan] + (["--check-quorum"] if cq else [])
    ref = reference_line(argv + [out_flag, str(tmp_path / "r.json")],
                         capsys, monkeypatch)
    ours = port_line(argv + [out_flag, str(tmp_path / "p.json")], capsys)
    assert_same_line(ours, ref)
    report = json.loads((tmp_path / "p.json").read_text())
    assert report == json.loads((tmp_path / "r.json").read_text())
    assert report == ours["report"]
    assert not any(report["safety"].values())


@pytest.mark.parametrize("plan", ["", CHAOS], ids=["bench-plan", "partition-heal"])
def test_autopilot(plan, capsys, monkeypatch, tmp_path):
    argv = ["--autopilot"] + (["--autopilot-plan", plan] if plan else [])
    ref = reference_line(argv + ["--autopilot-out", str(tmp_path / "r.json")],
                         capsys, monkeypatch)
    ours = port_line(argv + ["--autopilot-out", str(tmp_path / "p.json")], capsys)
    assert_same_line(ours, ref)
    assert (json.loads((tmp_path / "p.json").read_text())
            == json.loads((tmp_path / "r.json").read_text()))
    if plan:
        # The transfer arm acts under this plan and the reference's
        # defaults (cadence 16).
        assert ours["actions"]["transfers"] > 0
