"""The port's report tools and forensics smoke (raft_tpu_torch/tools/)
against the repository's tools/ on the CPU, on cut corpora of the golden
plans under tests/testdata/ at the sizes the JAX tests use: each report
tool writes the same JSON document and exits with the same code, and the
forensics smoke names the same offenders and writes the same incident and
repro files.  The port's smoke also drives the report tools' on-failure
tail (capture_artifacts, report_failures, capture_chaos_incident)."""

import json
import sys
from pathlib import Path

import pytest

from raft_tpu_torch.tools import (
    autopilot_report,
    chaos_churn_report,
    forensics_smoke,
    reconfig_report,
)

ROOT = Path(__file__).resolve().parent.parent
CHAOS_PLANS = ROOT / "tests" / "testdata" / "chaos" / "plans.json"
RECONFIG_PLANS = ROOT / "tests" / "testdata" / "reconfig" / "plans.json"


def cut_corpus(path, names, tmp_path):
    docs = [d for d in json.loads(path.read_text()) if d["name"] in names]
    assert {d["name"] for d in docs} == set(names)
    out = tmp_path / f"corpus-{path.parent.name}.json"
    out.write_text(json.dumps(docs))
    return out


def reference_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    return module.main()


@pytest.mark.parametrize("fused", [False, True], ids=["runner", "fused"])
def test_chaos_churn_report(fused, tmp_path, monkeypatch):
    import tools.chaos_churn_report as ref

    plans = cut_corpus(CHAOS_PLANS, {"asymmetric-link", "rolling-crash"}, tmp_path)
    argv = ["--groups", "16", "--plans", str(plans)] + (["--fused"] if fused else [])
    rc_ref = reference_main(ref, argv + ["--out", str(tmp_path / "r.json")],
                            monkeypatch)
    rc = chaos_churn_report.main(argv + ["--out", str(tmp_path / "p.json"),
                                         "--device", "cpu"])
    ours = json.loads((tmp_path / "p.json").read_text())
    assert ours == json.loads((tmp_path / "r.json").read_text())
    assert rc == rc_ref == 0
    if fused:
        assert sum(p["damped_fused"]["fused_rounds"] for p in ours["plans"].values())


def test_reconfig_report(tmp_path, monkeypatch):
    import tools.reconfig_report as ref

    corpus = cut_corpus(RECONFIG_PLANS, {"joint_exit_blocked", "joint_entry_split"},
                        tmp_path)
    monkeypatch.setattr(ref, "CORPUS", str(corpus))
    monkeypatch.setattr(reconfig_report, "CORPUS", str(corpus))
    rc_ref = reference_main(ref, ["--groups", "16", "--out", str(tmp_path / "r.json")],
                            monkeypatch)
    rc = reconfig_report.main(["--groups", "16", "--out", str(tmp_path / "p.json"),
                               "--device", "cpu"])
    ours = json.loads((tmp_path / "p.json").read_text())
    assert ours == json.loads((tmp_path / "r.json").read_text())
    assert rc == rc_ref == 0
    assert ours["plans"]["joint_exit_blocked"]["undamped"]["reconfig_stalled_groups"]


def test_autopilot_report(tmp_path, monkeypatch):
    """At test_autopilot.py's size (--groups 16 --cadence 5)."""
    import tools.autopilot_report as ref

    plans = cut_corpus(CHAOS_PLANS, {"flapping-bridge", "rolling-crash"}, tmp_path)
    argv = ["--groups", "16", "--cadence", "5", "--plans", str(plans)]
    rc_ref = reference_main(ref, argv + ["--out", str(tmp_path / "r.json")],
                            monkeypatch)
    rc = autopilot_report.main(argv + ["--out", str(tmp_path / "p.json"),
                                       "--device", "cpu"])
    ours = json.loads((tmp_path / "p.json").read_text())
    assert ours == json.loads((tmp_path / "r.json").read_text())
    assert rc == rc_ref
    assert sum(sum(p["on"]["actions"].values()) for p in ours["plans"].values())


def test_forensics_smoke(tmp_path, monkeypatch):
    import tools.forensics_smoke as ref

    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    rdir.mkdir()
    pdir.mkdir()
    assert reference_main(ref, ["--out-dir", str(rdir), "--groups", "8"],
                          monkeypatch) == 0
    assert forensics_smoke.main(["--out-dir", str(pdir), "--groups", "8",
                                 "--device", "cpu"]) == 0
    theirs = json.loads((rdir / "smoke-summary.json").read_text())
    ours = json.loads((pdir / "smoke-summary.json").read_text())
    for trap in ("commit_regress", "clock_pause"):
        for k in ("slot", "group", "round", "reproduced"):
            assert ours[trap][k] == theirs[trap][k], (trap, k)
        assert ((pdir / f"{trap}.json").read_text()
                == (rdir / f"{trap}.json").read_text()), trap
        # The repro text is the same below its first line, which names the
        # generating package.
        ours_txt, theirs_txt = ((d / f"{trap}_repro.txt").read_text().split("\n", 1)
                                for d in (pdir, rdir))
        assert ours_txt[1] == theirs_txt[1], trap
        assert "raft_tpu_torch.multiraft.forensics" in ours_txt[0]
    # The report tools' on-failure tail.
    tail = ours["report_tail"]
    assert tail["commit_regress"]["slot"] == "commit_regressed"
    assert tail["commit_regress"]["group"] == 1
    assert tail["commit_regress"]["reproduced"] is False
    assert Path(tail["commit_regress"]["incident_path"]).exists()
    assert "no captured offenders" in tail[forensics_smoke.HEALTHY_PLAN]["error"]
