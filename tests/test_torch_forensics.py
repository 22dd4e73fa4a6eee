"""The port's forensics layer against the JAX package on the CPU:

  * the commit-regress trap at G=8, offenders [1, 5], through both
    packages: the same safety counts, capture, incident JSON (the decoded
    ring windows included) and repro scenario (below its first line, the
    one that names the generating package); the port's repro replays RED,
    then green with the trap disabled, on the port's scalar copy;
  * both committed goldens (tests/testdata/forensics/) replay to their
    recorded outcome through the port's replay, run by the port's
    datadriven runner;
  * the port's clock-pause trap at G=2 writes clock_pause.txt below its
    first line (the golden stands in for the reference's damped run), and
    its repro replays RED-then-green;
  * the host-side pieces on the same inputs as the reference's: the
    scenario render/parse pairs, pick_offender, decode_window,
    schedule_records, report_failures, and capture_chaos_incident's
    refusal of a clean run."""

import json
import os

import numpy as np
import pytest

from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import forensics as jfx
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import forensics as tfx
from raft_tpu_torch.scalar import datadriven as tdd

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata")
GOLDEN = os.path.join(TESTDATA, "forensics")


def _lines(path):
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def _exact_offenders(session, slot, offenders):
    cap = session.sim.forensics()
    assert sorted(o["group"] for o in cap["offenders"][slot]) == sorted(offenders)
    assert cap["counts"][slot] == len(offenders)
    for name, offs in cap["offenders"].items():
        assert all(o["group"] in offenders for o in offs), name


def _red_then_green(path, slot):
    red = tfx.replay_scenario(path)
    assert red["fired"][slot] > 0 and red["outcome"] == red["expected"]
    green = tfx.replay_scenario(path, disable_traps=True)
    assert not any(green["fired"].values()), green["fired"]


def test_commit_regress_trap_matches_jax(tmp_path):
    want = jfx.run_commit_regress_trap(n_groups=8, offenders=[1, 5])
    got = tfx.run_commit_regress_trap(n_groups=8, offenders=[1, 5], device="cpu")
    np.testing.assert_array_equal(got.safety, want.safety)
    assert got.safety[2] == 2  # commit_regressed
    _exact_offenders(got, "commit_regressed", [1, 5])
    assert got.sim.forensics() == want.sim.forensics()
    assert got.sim.incident_report() == jfx.build_incident(want.sim)
    outs = {}
    for name, session in (("jax", want), ("torch", got)):
        outs[name] = session.extract(str(tmp_path / name))
    for key in ("slot", "group", "round", "reproduced", "fired"):
        assert outs["torch"][key] == outs["jax"][key], key
    assert outs["torch"]["group"] == 1 and outs["torch"]["reproduced"]
    tlines, jlines = (_lines(outs[n]["scenario_path"]) for n in ("torch", "jax"))
    assert tlines[0] == jlines[0].replace("raft_tpu.", "raft_tpu_torch.")
    assert tlines[1:] == jlines[1:] == _lines(os.path.join(GOLDEN, "commit_regress.txt"))[1:]
    with open(outs["torch"]["incident_path"], encoding="utf-8") as f:
        incident = json.load(f)
    with open(outs["jax"]["incident_path"], encoding="utf-8") as f:
        assert incident == json.load(f)
    assert incident["schema"] == tfx.SCHEMA and incident["headline"]["group"] == 1
    assert any("commit_regressed" in rec["fired"] for rec in incident["windows"]["1"])
    _red_then_green(outs["torch"]["scenario_path"], "commit_regressed")


def test_goldens_replay_through_the_port():
    ran = []

    def handle(td):
        assert td.cmd == "repro"
        meta = tfx.meta_from_args({a.key: a.vals for a in td.cmd_args})
        rounds = tfx.parse_rounds(td.input, meta["peers"])
        return tfx.render_outcome(meta, tfx.replay(meta, rounds))

    def run(path):
        tdd.run_test(path, handle)
        ran.append(os.path.basename(path))

    tdd.walk(GOLDEN, run)
    assert ran == ["clock_pause.txt", "commit_regress.txt"]
    for name, slot in (("clock_pause.txt", "stale_read"),
                       ("commit_regress.txt", "commit_regressed")):
        _red_then_green(os.path.join(GOLDEN, name), slot)
        want = jfx.replay_scenario(os.path.join(GOLDEN, name))
        got = tfx.replay_scenario(os.path.join(GOLDEN, name))
        assert got == want


def test_clock_pause_trap_writes_the_golden(tmp_path):
    session = tfx.run_clock_pause_trap(n_groups=2, offenders=[1], device="cpu")
    assert session.safety[7] > 0 and session.safety[8] > 0  # stale_read, dual_lease
    _exact_offenders(session, "stale_read", [1])
    _exact_offenders(session, "dual_lease", [1])
    out = session.extract(str(tmp_path))
    assert (out["slot"], out["group"], out["reproduced"]) == ("stale_read", 1, True)
    assert out["fired"]["dual_lease"] > 0
    got = _lines(out["scenario_path"])
    assert got[0] == f"# Generated by raft_tpu_torch.multiraft.forensics ({tfx.SCHEMA})."
    assert got[1:] == _lines(os.path.join(GOLDEN, "clock_pause.txt"))[1:]
    _red_then_green(out["scenario_path"], "stale_read")
    window = session.sim.incident_report()["windows"]["1"]
    assert len(window) == session.cfg.blackbox_window
    assert window[-1]["round"] == 59 and "stale_read" in window[-1]["fired"]


def test_scenario_format_round_trips_as_jax():
    P = 3
    recs = [tfx.RoundRecord(crashed=[False] * P) for _ in range(6)]
    recs[0].append = 2
    recs[1].crashed = [True, False, True]
    recs[2].link = [[True, False, True], [True, True, True], [False, True, True]]
    recs[3].read = 2
    recs[4].freeze = 3
    recs[5].regress = (2, 4)
    recs[5].read = 1
    jrecs = [jfx.RoundRecord(crashed=list(r.crashed), link=r.link, append=r.append,
                             read=r.read, freeze=r.freeze, regress=r.regress)
             for r in recs]
    text = tfx.render_rounds(recs, P)
    assert text == jfx.render_rounds(jrecs, P)
    parsed = tfx.parse_rounds(text, P)
    assert {r: vars(v) for r, v in parsed.items()} == {
        r: vars(v) for r, v in jfx.parse_rounds(text, P).items()}
    assert [vars(parsed[r]) for r in range(6)] == [vars(r) for r in recs]
    meta = {"slot": "dual_lease", "group": 7, "peers": P, "rounds": 6,
            "election_tick": 10, "heartbeat_tick": 1, "check_quorum": 1,
            "pre_vote": 0, "lease_read": 1, "voters": [1, 2], "outgoing": [2, 3],
            "learners": []}
    line = tfx.render_meta(meta)
    assert line == jfx.render_meta(meta)
    args = {}
    for part in line.split()[1:]:
        key, _, val = part.partition("=")
        args[key] = val.strip("()").split(",")
    assert tfx.meta_from_args(args) == jfx.meta_from_args(args) == meta
    result = tfx.replay(meta, parsed)
    assert result == jfx.replay(meta, jfx.parse_rounds(text, P))
    assert tfx.render_outcome(meta, result) == jfx.render_outcome(meta, result)
    assert tfx.scenario_text(meta, recs, "x").splitlines()[1:] == \
        jfx.scenario_text(meta, jrecs, "x").splitlines()[1:]
    for bad in ("x1 append=1", "r1 bogus=2"):
        with pytest.raises(ValueError):
            tfx.parse_rounds(bad, P)
    with pytest.raises(ValueError):
        tfx.parse_rounds("r0 link=101", P)


def test_capture_helpers_match_jax():
    counts = {name: 0 for name in tfx.kernels.SAFETY_NAMES}
    offenders = {name: [] for name in tfx.kernels.SAFETY_NAMES}
    counts.update(dual_lease=2, commit_regressed=1)
    offenders["dual_lease"] = [{"group": 4, "round": 9}, {"group": 1, "round": 12}]
    offenders["commit_regressed"] = [{"group": 3, "round": 2}]
    cap = {"counts": counts, "offenders": offenders}
    for slot in (None, "commit_regressed"):
        assert tfx.pick_offender(cap, slot) == jfx.pick_offender(cap, slot)
    for slot in ("stale_read", None):
        empty = {"counts": {n: 0 for n in counts}, "offenders": offenders}
        with pytest.raises(ValueError):
            tfx.pick_offender(empty if slot is None else cap, slot)
    rng = np.random.RandomState(4)
    meta = rng.randint(0, 1 << 15, size=6).astype(np.uint32)
    term, commit = rng.randint(0, 9, size=6), rng.randint(0, 50, size=6)
    for folded in (0, 4, 6, 13):
        assert tfx.decode_window(meta, term, commit, folded) == \
            jfx.decode_window(meta, term, commit, folded)
    doc = {"name": "cut", "peers": 3, "phases": [
        {"rounds": 4, "append": 1},
        {"rounds": 5, "partition": [[1], [2, 3]], "loss_all": 0.2, "append": 2,
         "crash": [3], "groups": {"mod": 2, "eq": 1}},
        {"rounds": 3, "heal": True}]}
    tsched = tchaos.HostSchedule(tchaos.plan_from_dict(doc), 6)
    jsched = jchaos.HostSchedule(jchaos.plan_from_dict(doc), 6)
    for g in range(6):
        assert [vars(r) for r in tfx.schedule_records(tsched, g)] == \
            [vars(r) for r in jfx.schedule_records(jsched, g)]


def test_report_failures_and_clean_capture(tmp_path, capsys):
    def capture(name, ok):
        if not ok:
            raise RuntimeError("boom")
        return {"slot": "dual_leader", "group": 3, "round": 5, "reproduced": False,
                "incident_path": "i.json", "scenario_path": "s.txt"}

    got, want = {}, {}
    tfx.report_failures({"a": (True,), "b": (False,)}, got, capture)
    jfx.report_failures({"a": (True,), "b": (False,)}, want, capture)
    assert got == want
    assert got["forensics"]["b"] == {"error": "boom"}
    assert "device-only" in capsys.readouterr().err
    # A clean chaos run captures nothing, and extract_repro says so.
    with open(os.path.join(TESTDATA, "chaos", "plans.json"), encoding="utf-8") as f:
        plan = json.load(f)[0]
    with pytest.raises(ValueError, match="no captured offenders"):
        tfx.capture_chaos_incident(plan, 4, str(tmp_path), device="cpu")
