"""The port's chaos scenario runner against the JAX package's, on the CPU,
exactly: `ClusterSim(chaos=plan, device="cpu").run_plan()` against JAX's
`ClusterSim(chaos=plan).run_plan()` on the six golden plans
(tests/testdata/chaos/plans.json) at G=8, P=3, with check_quorum off and
on (every SimState field, the health planes and window position, the
report dict and the monitor's ring entry); the golden outputs of
tests/testdata/chaos/scenarios.txt reproduced through the harness of
tests/test_chaos_datadriven.py re-expressed on the port; and the prefix
property (the first 8 groups of a G=13 run equal a G=8 run: every seeded
stream and the group selectors key on the global group id).

Each JAX run_plan compiles its own scan (a few seconds at G=8), one per
plan and flag; the port runs on the plain PyTorch step."""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu.datadriven import TestData, run_test, walk
from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import assert_states_equal

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata")
G, P, WINDOW = 8, 3, 8

with open(os.path.join(TESTDATA, "chaos", "plans.json"), encoding="utf-8") as _f:
    PLANS = {d["name"]: d for d in json.load(_f)}


class Trace:
    """A metrics stand-in that records trace events."""

    def __init__(self):
        self.events = []

    def on_health_summary(self, summary):
        pass

    def trace(self, event, **fields):
        self.events.append((event, fields))


def assert_health_equal(jh, th, note):
    assert th.planes.dtype == torch.int32, note
    np.testing.assert_array_equal(th.planes.numpy(), np.asarray(jh.planes), err_msg=note)
    assert th.window_pos == int(jh.window_pos), note


@pytest.mark.parametrize("cq", [False, True], ids=["undamped", "check_quorum"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_run_plan_matches_jax(name, cq):
    kw = dict(n_groups=G, n_peers=P, collect_health=True, health_window=WINDOW,
              check_quorum=cq)
    jmon, tmon = JMonitor(), HealthMonitor(metrics=Trace())
    jsm = jsim.ClusterSim(jsim.SimConfig(**kw), health_monitor=jmon,
                          chaos=jchaos.plan_from_dict(PLANS[name]))
    tsm = tsim.ClusterSim(tsim.SimConfig(**kw), health_monitor=tmon,
                          chaos=tchaos.plan_from_dict(PLANS[name]), device="cpu")
    want, got = jsm.run_plan(), tsm.run_plan()
    assert got == want
    assert_states_equal(jsm.state, tsm.state, name)
    assert_health_equal(jsm._health, tsm._health, name)
    assert tmon.last()["chaos"] == jmon.last()["chaos"] == want
    trace = tmon.metrics.events
    assert [e for e, _ in trace] == ["chaos.scenario"]
    assert trace[0][1]["reelections"] == want["reelections"]
    assert not any(want["safety"].values())


def test_run_plan_twice_continues_and_reports_safety_trace():
    """A second run_plan continues from the first's state and health (the
    cached runner), as the reference's does; a report with a nonzero
    safety count raises the chaos.safety trace event."""
    kw = dict(n_groups=G, n_peers=P, collect_health=True, health_window=WINDOW)
    plan = PLANS["symmetric-split"]
    jsm = jsim.ClusterSim(jsim.SimConfig(**kw), chaos=jchaos.plan_from_dict(plan))
    tsm = tsim.ClusterSim(tsim.SimConfig(**kw), chaos=tchaos.plan_from_dict(plan),
                          device="cpu")
    for _ in range(2):
        assert tsm.run_plan() == jsm.run_plan()
    assert_states_equal(jsm.state, tsm.state, "second run")
    assert_health_equal(jsm._health, tsm._health, "second run")
    mon = HealthMonitor(metrics=Trace())
    bad = HealthMonitor.chaos_report([1, 5, 3, 7], [0, 1] + [0] * 7, 10)
    assert bad["mttr_rounds"] == 5.0 and bad["safety"]["commit_diverged"] == 1
    assert bad == JMonitor.chaos_report([1, 5, 3, 7], [0, 1] + [0] * 7, 10)
    mon.record_scenario(bad)
    assert [e for e, _ in mon.metrics.events] == ["chaos.scenario", "chaos.safety"]
    assert len(mon) == 1 and mon.summary_ring()[0]["chaos"] == bad


@pytest.mark.parametrize("cq", [False, True], ids=["undamped", "check_quorum"])
def test_prefix_property(cq):
    """Groups are independent: the first 8 groups of a G=13 run equal a G=8
    run on every field and health plane (heal-all's phase 3 selects even
    groups by id)."""
    plan = tchaos.plan_from_dict(PLANS["heal-all"])
    runs = {}
    for g in (8, 13):
        cfg = tsim.SimConfig(n_groups=g, n_peers=P, collect_health=True,
                             health_window=WINDOW, check_quorum=cq)
        compiled = tchaos.compile_plan(plan, g, device="cpu")
        st, health, stats, safety = tchaos.run_plan(
            cfg, tsim.init_state(cfg, device="cpu"), compiled, device="cpu")
        assert not safety.any()
        runs[g] = st, health
    (small, h_small), (big, h_big) = runs[8], runs[13]
    for f in tsim.SimState._fields:
        a, b = getattr(small, f), getattr(big, f)
        if a is None:
            assert b is None
            continue
        assert torch.equal(a, b[..., :8]), f
    assert torch.equal(h_small.planes, h_big.planes[:, :8])


def test_entry_points_default_to_cuda():
    """compile_plan, run_plan and ClusterSim(chaos=) allocate on `cuda`
    unless told otherwise, and raise rather than fall back where there is
    no card."""
    cfg = tsim.SimConfig(4, 3, collect_health=True)
    plan = tchaos.plan_from_dict(PLANS["heal-all"])
    cpu_state = tsim.init_state(cfg, device="cpu")
    cpu_plan = tchaos.compile_plan(plan, 4, device="cpu")
    calls = (lambda: tchaos.compile_plan(plan, 4),
             lambda: tchaos.run_plan(cfg, cpu_state, cpu_plan),
             lambda: tsim.ClusterSim(cfg, chaos=plan))
    if torch.cuda.is_available():
        assert tchaos.compile_plan(plan, 4).link_packed.is_cuda
        assert tsim.ClusterSim(cfg, chaos=plan).state.term.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
    # A black-box config's runner takes the BlackboxState after the health.
    with pytest.raises(TypeError, match="BlackboxState"):
        tchaos.make_runner(cfg._replace(blackbox=True), cpu_plan)(
            cpu_state, tsim.init_health(cfg, "cpu"))
    with pytest.raises(ValueError, match="compiled for"):
        tchaos.make_runner(cfg._replace(n_groups=5), cpu_plan)
    with pytest.raises(RuntimeError, match="collect_health"):
        tsim.ClusterSim(cfg._replace(collect_health=False), chaos=plan,
                        device="cpu").run_plan()
    with pytest.raises(RuntimeError, match="no chaos plan"):
        tsim.ClusterSim(cfg, device="cpu").run_plan()


class PortChaosHarness:
    """tests/test_chaos_datadriven.py's ChaosHarness on the port: one
    (G=8, P=3, window=8) ClusterSim, reset between cases, stepped round by
    round through the host schedule's masks with the safety invariants
    folded every round."""

    def __init__(self):
        self.cfg = tsim.SimConfig(n_groups=G, n_peers=P, collect_health=True,
                                  health_window=WINDOW)
        self.sim = tsim.ClusterSim(self.cfg, device="cpu")
        self.safety_fn = getattr(tk, "check_safety")

    def handle(self, td: TestData) -> str:
        if td.cmd != "run":
            raise ValueError(f"unknown command {td.cmd}")
        plan = tchaos.plan_from_dict(PLANS[td.arg("plan").value])
        sched = tchaos.HostSchedule(plan, G)
        sim = self.sim
        sim.state = tsim.init_state(self.cfg, device="cpu")
        sim.reset_health()
        safety = np.zeros(tk.N_SAFETY, np.int64)
        reelections = healed = 0
        prev_leaderless = np.zeros(G, np.int64)
        prev_commit = sim.state.commit
        for r in range(plan.n_rounds):
            link, crashed, append = sched.masks(r)
            sim.run_round(torch.from_numpy(crashed), torch.from_numpy(append),
                          link=torch.from_numpy(link))
            st = sim.state
            safety += self.safety_fn(st.state, st.term, st.commit, st.last_index,
                                     st.agree, prev_commit).numpy()
            prev_commit = st.commit
            leaderless = sim._health.planes[tk.HP_LEADERLESS].numpy().astype(np.int64)
            ended = (prev_leaderless > 0) & (leaderless == 0)
            reelections += int(ended.sum())
            healed += int(prev_leaderless[ended].sum())
            prev_leaderless = leaderless
        planes = sim._health.planes.numpy()
        st = sim.state
        out = [
            f"{name}: {' '.join(str(v) for v in planes[i])}"
            for i, name in enumerate(tk.HEALTH_PLANE_NAMES)
        ]
        leaders = (st.state == tk.ROLE_LEADER).sum(0).tolist()
        out.append("leaders: " + " ".join(str(v) for v in leaders))
        out.append("max_term: " + " ".join(str(v) for v in st.term.amax(0).tolist()))
        out.append("commit: " + " ".join(str(v) for v in st.commit.amax(0).tolist()))
        out.append("safety: " + " ".join(
            f"{k}={v}" for k, v in zip(tk.SAFETY_NAMES, safety)))
        out.append(f"reelections: {reelections} healed_rounds: {healed}")
        return "\n".join(out)


def test_chaos_golden_scenarios_on_the_port():
    harness = PortChaosHarness()
    ran = []

    def run(path):
        run_test(path, harness.handle, rewrite=False)
        ran.append(path)

    walk(os.path.join(TESTDATA, "chaos"), run)
    assert ran
