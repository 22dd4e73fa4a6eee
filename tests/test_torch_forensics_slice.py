"""The runners' black-box arms against the JAX package on the CPU, exactly:
each folds kernels.check_safety_groups and the round's record into the
black box, and the state, the report and the safety counts equal the
black-box-off run's (the recorder is a pure observer).

  * `ClusterSim(chaos=).run_plan()` (chaos.make_runner) on a golden chaos
    plan, check_quorum off and on;
  * `ClusterSim.run_reconfig` (reconfig.make_runner over _runner_body,
    with the tail audit's mark) on a golden reconfig plan with its chaos
    overlay, and `split=True` on a black-box config (the unsplit runner,
    fused_rounds 0);
  * `Autopilot.run_plan` (the cadence runner and its tail audit) on the
    crash-heal plan with the loop on;
  * `ClusterSim.run_reads` (the workload runner) on the read-storm plan.

Each compares the whole BlackboxState (ring, trip plane, round count),
the report and the end state.  A file of its own: each JAX runner
compiles its own scan."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import ClusterSim as JClusterSim
from raft_tpu.multiraft import autopilot as jap
from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft import workload as jwl
from raft_tpu_torch.multiraft import autopilot as tap
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl

from test_torch_autopilot import CRASH_PLAN
from test_torch_blackbox import assert_bb_equal
from test_torch_sim import assert_states_equal

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata")
G, P = 8, 3


def _plans(kind):
    with open(os.path.join(TESTDATA, kind, "plans.json"), encoding="utf-8") as f:
        return {d["name"]: d for d in json.load(f)}


def _observer(tcfg, run, want_report, want_state, **kw):
    """The same run with the black box off: the same report and state."""
    off = tsim.ClusterSim(tcfg._replace(blackbox=False), device="cpu", **kw)
    assert run(off) == want_report
    assert_states_equal(want_state, off.state, "black box off")


@pytest.mark.parametrize("cq", [False, True], ids=["undamped", "check_quorum"])
def test_chaos_runner_blackbox_matches_jax(cq):
    doc = _plans("chaos")["symmetric-split"]
    kw = dict(n_groups=G, n_peers=P, collect_health=True, health_window=8,
              check_quorum=cq, blackbox=True, blackbox_window=6)
    js = JClusterSim(jsim.SimConfig(**kw), chaos=jchaos.plan_from_dict(doc))
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), chaos=tchaos.plan_from_dict(doc),
                         device="cpu")
    want, got = js.run_plan(), ts.run_plan()
    assert got == want and not any(got["safety"].values())
    assert_states_equal(js.state, ts.state, "end state")
    assert_bb_equal(js._blackbox, ts._blackbox, "black box")
    assert ts._blackbox.round_idx == got["rounds"]
    assert ts.forensics() == js.forensics()
    _observer(ts.cfg, lambda s: s.run_plan(), got, ts.state,
              chaos=tchaos.plan_from_dict(doc))


def test_reconfig_runner_blackbox_matches_jax():
    doc = _plans("reconfig")["rolling_churn"]
    kw = dict(n_groups=G, n_peers=P, collect_health=True, health_window=8,
              blackbox=True, blackbox_window=5)
    jp, tp = jrc.plan_from_dict(doc["reconfig"]), trc.plan_from_dict(doc["reconfig"])
    jc, tc = jchaos.plan_from_dict(doc["chaos"]), tchaos.plan_from_dict(doc["chaos"])
    js = JClusterSim(jsim.SimConfig(**kw), *map(jnp.asarray, (
        np.asarray(m) for m in jrc.initial_masks(jp, G))))
    tmasks = trc.initial_masks(tp, G, "cpu")
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), *tmasks, device="cpu")
    want, got = js.run_reconfig(jp, jc), ts.run_reconfig(tp, tc)
    assert got == want and got["ops_applied"] > 0
    assert not any(got["safety"].values())
    assert_states_equal(js.state, ts.state, "end state")
    assert_bb_equal(js._blackbox, ts._blackbox, "black box")
    _observer(ts.cfg, lambda s: s.run_reconfig(tp, tc), got, ts.state,
              voter_mask=tmasks[0], outgoing_mask=tmasks[1], learner_mask=tmasks[2])
    # A black-box config never fuses: split=True runs the unsplit runner.
    js2 = JClusterSim(jsim.SimConfig(**kw), *map(jnp.asarray, (
        np.asarray(m) for m in jrc.initial_masks(jp, G))))
    ts2 = tsim.ClusterSim(tsim.SimConfig(**kw), *tmasks, device="cpu")
    want2, got2 = js2.run_reconfig(jp, jc, split=True), ts2.run_reconfig(tp, tc, split=True)
    assert got2 == want2
    assert (got2["fused_rounds"], got2["fused_frac"]) == (0, 0.0)
    assert {k: v for k, v in got2.items() if k not in (
        "fused_rounds", "total_rounds", "fused_frac")} == got
    assert_bb_equal(js2._blackbox, ts2._blackbox, "split black box")


def test_autopilot_blackbox_matches_jax():
    kw = dict(n_groups=G, n_peers=P, collect_health=True, transfer=True,
              commit_stall_ticks=8, blackbox=True, blackbox_window=7)
    apkw = dict(cadence=5, kick=True, transfer=True, kick_leaderless_ticks=2)
    js = JClusterSim(jsim.SimConfig(**kw))
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), device="cpu")
    want = jap.Autopilot(js, jap.AutopilotConfig(**apkw)).run_plan(
        jchaos.plan_from_dict(CRASH_PLAN))
    got = tap.Autopilot(ts, tap.AutopilotConfig(**apkw)).run_plan(
        tchaos.plan_from_dict(CRASH_PLAN))
    assert got == want and got["actions"]["kicks"] > 0
    assert_states_equal(js.state, ts.state, "end state")
    assert_bb_equal(js._blackbox, ts._blackbox, "black box")
    assert ts._blackbox.round_idx == got["rounds"]
    off = tsim.ClusterSim(ts.cfg._replace(blackbox=False), device="cpu")
    rep = tap.Autopilot(off, tap.AutopilotConfig(**apkw)).run_plan(
        tchaos.plan_from_dict(CRASH_PLAN))
    assert rep == got
    assert_states_equal(ts.state, off.state, "black box off")


def test_workload_runner_blackbox_matches_jax():
    doc = {"name": "reads", "peers": P, "phases": [
        {"rounds": 30, "append": 1},
        {"rounds": 24, "append": 1, "read_every": 2, "read_mode": "lease"},
        {"rounds": 16, "append": 1, "read_every": 3, "read_mode": "safe"}]}
    kw = dict(n_groups=G, n_peers=P, collect_health=True, check_quorum=True,
              lease_read=True, blackbox=True)
    js = JClusterSim(jsim.SimConfig(**kw))
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), device="cpu")
    want = js.run_reads(jwl.plan_from_dict(doc), split=True)
    got = ts.run_reads(twl.plan_from_dict(doc), split=True)
    assert got == want and got["fused_rounds"] == 0
    assert got["served_lease"] > 0 and not any(got["safety"].values())
    assert_states_equal(js.state, ts.state, "end state")
    assert_bb_equal(js._blackbox, ts._blackbox, "black box")
