"""The port's autopilot against the JAX package on the CPU, exactly:

  * the policy (`Autopilot._decide`) on the same health summaries and
    `explain()` columns (tests/test_autopilot.py's `_FakeSim` pattern): the
    kick budget and cooldown, the retry rotation, the transfer off a
    stalled leader, learners skipped, the leader taken from the role
    columns; the action planes, the inspected columns, the cooldowns, the
    rotation and the action counts;
  * `Autopilot.balance_transfers` on a settled fleet (with and without a
    crash plane) and `_decide_evacuation`'s plan;
  * `make_cadence_runner(fused=False)` against the reference's, segment by
    segment over a chaos plan with transfer commands and kicks: every
    output;
  * `Autopilot.run_plan` end to end at tests/test_autopilot.py's crash-heal
    config (the loop on and off, and leader balancing over a skewed
    workload): the report, the actions, the end state, the health planes
    and the monitor's summaries;
  * `HealthMonitor.record_autopilot`, and the entry points' default device.

Kernel functions are looked up by name (getattr), so the JAX package's
parity-obligation baseline stays as it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import ClusterSim as JClusterSim
from raft_tpu.multiraft import autopilot as jap
from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import runner as jrunner
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import autopilot as tap
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import assert_states_equal

CRASH_PLAN = {
    "name": "crash-heal",
    "peers": 3,
    "phases": [
        {"rounds": 14, "append": 1},
        {"rounds": 16, "crash": [1], "append": 1},
        {"rounds": 12, "heal": True, "append": 1},
    ],
}


class _FakeSim:
    """Just enough ClusterSim surface for the policy."""

    def __init__(self, sim_mod, explains, state=None):
        self.cfg = sim_mod.SimConfig(n_groups=8, n_peers=3)
        self._explains = explains
        self.state = state

    def explain(self, g):
        return self._explains[g]


def _info(g, leaderless=0, since=0, leader=0, last=(10, 10, 10),
          commit=(9, 9, 9), voter=(True, True, True)):
    return {
        "group": g,
        "health": {"leaderless_ticks": leaderless, "ticks_since_commit": since,
                   "term_bumps_in_window": 0, "vote_splits": 0},
        "peers": {
            "term": [1, 1, 1],
            "state": [2 if p + 1 == leader else 0 for p in range(3)],
            "commit": list(commit),
            "last_index": list(last),
            "leader_id": [leader] * 3,
            "voter": list(voter),
            "learner": [not v for v in voter],
        },
    }


def _summary(worst):
    return {"counts": {"leaderless": 0, "stalled_leaderless": 0,
                       "commit_stalled": 0, "churning": 0},
            "lag_hist": [0] * 8, "worst": worst}


def _stale_views():
    info = _info(0, since=9, leader=1, last=(9, 9, 8), commit=(9, 8, 5))
    info["peers"]["leader_id"] = [3, 3, 3]
    return {0: info}


# (explains, config, rounds of (worst, round_idx)) of tests/test_autopilot.py.
POLICY_CASES = {
    "kick_budget": (
        lambda: {g: _info(g, leaderless=5, last=(4, 9, 7), commit=(4, 8, 7))
                 for g in range(8)},
        dict(max_kicks=3, kick_leaderless_ticks=2),
        [([{"group": g, "score": 5} for g in range(8)], 10),
         ([{"group": g, "score": 5} for g in range(3)], 12)]),
    "kick_rotation": (
        lambda: {0: _info(0, leaderless=5, last=(9, 6, 3), commit=(9, 6, 3))},
        dict(cooldown=0),
        [([{"group": 0, "score": 5}], r) for r in range(3)]),
    "transfer_stalled_leader": (
        lambda: {2: _info(2, since=9, leader=3, last=(8, 9, 9), commit=(5, 5, 9))},
        dict(transfer_stall_ticks=6),
        [([{"group": 2, "score": 9}], 20)]),
    "transfer_skips_learners": (
        lambda: {0: _info(0, since=9, leader=3, last=(8, 9, 7), commit=(5, 9, 5),
                          voter=(True, False, True))},
        dict(transfer_stall_ticks=6, cooldown=0),
        [([{"group": 0, "score": 9}], r) for r in range(2)]),
    "leader_from_role_columns": (
        _stale_views, dict(transfer_stall_ticks=6),
        [([{"group": 0, "score": 9}], 0)]),
    "zero_scores_skipped": (
        lambda: {0: _info(0, leaderless=5), 1: _info(1, since=9, leader=1)},
        dict(),
        [([{"group": 0, "score": 0}, {"group": 1, "score": 9}], 4)]),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policy_matches_jax(case):
    make, kw, rounds = POLICY_CASES[case]
    want = jap.Autopilot(_FakeSim(jsim, make()), jap.AutopilotConfig(**kw))
    got = tap.Autopilot(_FakeSim(tsim, make()), tap.AutopilotConfig(**kw))
    acted = 0
    for worst, r in rounds:
        wt, wk, wi = want._decide(_summary(worst), r)
        gt, gk, gi = got._decide(_summary(worst), r)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gk, wk)
        assert gt.dtype == wt.dtype and gk.dtype == wk.dtype
        assert gi == wi
        acted += int(gt.astype(bool).sum() + gk.sum())
    assert got.actions_taken == want.actions_taken
    assert got._cooldown_until == want._cooldown_until
    assert got._retry_rotation == want._retry_rotation
    assert acted > 0


def test_config_validation():
    for bad in (dict(cadence=0), dict(cooldown=-1)):
        with pytest.raises(ValueError):
            jap.AutopilotConfig(**bad).validate()
        with pytest.raises(ValueError):
            tap.AutopilotConfig(**bad).validate()
    assert tap.AutopilotConfig()._asdict() == jap.AutopilotConfig()._asdict()


def _settled_sims(G=8, rounds=40):
    """A JAX and a port ClusterSim (transfer on) after `rounds` rounds of
    one append a group, states checked equal."""
    kw = dict(n_groups=G, n_peers=3, collect_health=True, transfer=True)
    js = JClusterSim(jsim.SimConfig(**kw))
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), device="cpu")
    for _ in range(rounds):
        js.state = js._step(js.state, jnp.zeros((3, G), bool), jnp.ones((G,), jnp.int32),
                            None, None, None, None)
        ts.state = tsim.step(ts.cfg, ts.state, torch.zeros((3, G), dtype=torch.bool),
                             torch.ones(G, dtype=torch.int32))
    assert_states_equal(js.state, ts.state, "settle")
    return js, ts


@pytest.mark.parametrize("crash", [False, True])
def test_balance_transfers_matches_jax(crash):
    js, ts = _settled_sims()
    lead = ts.state.leader_id.amax(0).numpy()
    w = np.ones(8, np.int64)
    hot = int(np.bincount(lead, minlength=4)[1:].argmax()) + 1
    w[lead == hot] = 10
    crashed = None
    if crash:
        crashed = np.zeros((3, 8), bool)
        crashed[hot % 3] = True  # one candidate destination is dead
    cfg = dict(balance=True, max_balance_transfers=2)
    want_ap = jap.Autopilot(js, jap.AutopilotConfig(**cfg))
    got_ap = tap.Autopilot(ts, tap.AutopilotConfig(**cfg))
    want = want_ap.balance_transfers(
        weights=w, round_idx=0, crashed=None if crashed is None else jnp.asarray(crashed))
    got = got_ap.balance_transfers(
        weights=w, round_idx=0,
        crashed=None if crashed is None else torch.from_numpy(crashed))
    np.testing.assert_array_equal(got, want)
    assert got.any()
    assert got_ap.actions_taken == want_ap.actions_taken
    assert got_ap._cooldown_until == want_ap._cooldown_until
    # The commands move leadership in one round, in both packages.
    jst = jsim.step(js.cfg, js.state, jnp.zeros((3, 8), bool), jnp.ones((8,), jnp.int32),
                    transfer_propose=jnp.asarray(want))
    tst = tsim.step(ts.cfg, ts.state, torch.zeros((3, 8), dtype=torch.bool),
                    torch.ones(8, dtype=torch.int32), transfer_propose=torch.from_numpy(got))
    assert_states_equal(jst, tst, "after the balance commands")
    moved = np.flatnonzero(got)
    assert (tst.leader_id.amax(0).numpy()[moved] == got[moved]).all()


def test_decide_evacuation_matches_jax():
    """Two groups whose voter 3 lags far behind: the same remove+add plan
    in both packages (the spare is the lowest peer outside the configs);
    nothing when too few groups implicate one voter."""
    P, G = 5, 8
    vm = np.zeros((P, G), bool)
    vm[:3] = True
    lm = np.zeros((P, G), bool)
    infos = []
    for g in (1, 4, 6):
        info = _info(g, since=20, leader=1, last=(40, 40, 12), commit=(40, 40, 12))
        for k in ("term", "state", "commit", "last_index", "leader_id", "voter",
                  "learner"):
            info["peers"][k] = info["peers"][k] + [info["peers"][k][-1]] * 2
        infos.append(info)

    def sims(min_groups):
        jfake = _FakeSim(jsim, {}, jsim.SimState(**dict(
            dict.fromkeys(jsim.SimState._fields), voter_mask=jnp.asarray(vm),
            learner_mask=jnp.asarray(lm))))
        tfake = _FakeSim(tsim, {}, tsim.SimState(**dict(
            dict.fromkeys(tsim.SimState._fields), voter_mask=torch.from_numpy(vm),
            learner_mask=torch.from_numpy(lm))))
        for fake, mod in ((jfake, jsim), (tfake, tsim)):
            fake.cfg = mod.SimConfig(n_groups=G, n_peers=P)
        kw = dict(evacuate=True, evac_stall_ticks=8, evac_min_groups=min_groups)
        return (jap.Autopilot(jfake, jap.AutopilotConfig(**kw)),
                tap.Autopilot(tfake, tap.AutopilotConfig(**kw)))

    for min_groups in (2, 4):
        want_ap, got_ap = sims(min_groups)
        want = want_ap._decide_evacuation(infos, 16, 40)
        got = got_ap._decide_evacuation(infos, 16, 40)
        assert (want is None) == (got is None) == (min_groups == 4)
        if want is not None:
            assert (got.name, got.n_peers, got.voters, got.learners) == (
                want.name, want.n_peers, want.voters, want.learners)
            assert [(ph.rounds, ph.op, ph.groups) for ph in got.phases] == [
                (ph.rounds, ph.op, ph.groups) for ph in want.phases]
        assert got_ap.actions_taken == want_ap.actions_taken
        assert got_ap._evacuated == want_ap._evacuated


# --- the cadence runner ----------------------------------------------------------


CADENCE_PLAN = {
    "name": "cadence", "peers": 3,
    "phases": [
        {"rounds": 8, "append": 1},
        {"rounds": 8, "crash": [1], "append": 1},
        {"rounds": 10, "heal": True, "append": 2},
    ],
}


def _runner_pair(G, cadence, fused, settle=16, plan=CADENCE_PLAN, **cfg_kw):
    """A maker of both cadence runners (segments of `cadence` rounds, the last
    a remainder) over `plan` from a settled transfer-on state, the
    reference's schedule arguments and the starting carries."""
    kw = dict(n_groups=G, n_peers=plan["peers"], collect_health=True, transfer=True,
              commit_stall_ticks=4, **cfg_kw)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    jst, tst = jsim.init_state(jcfg), tsim.init_state(tcfg, device="cpu")
    jstep = jax.jit(lambda s, c, a: jsim.step(jcfg, s, c, a))
    for _ in range(settle):
        jst = jstep(jst, jnp.zeros((3, G), bool), jnp.ones((G,), jnp.int32))
        tst = tsim.step(tcfg, tst, torch.zeros((3, G), dtype=torch.bool),
                        torch.ones(G, dtype=torch.int32))
    assert_states_equal(jst, tst, "settle")
    jcc = jchaos.compile_plan(jchaos.plan_from_dict(plan), G)
    tcc = tchaos.compile_plan(tchaos.plan_from_dict(plan), G, "cpu")
    R = jcc.n_rounds
    jcomp = jap.empty_reconfig_schedule(R, 3, G)
    tcomp = tap.empty_reconfig_schedule(R, 3, G, "cpu")
    jcarry = [jst, jsim.init_health(jcfg), jrc.init_reconfig_state(jst),
              jnp.zeros((jchaos.N_CHAOS_STATS,), jnp.int32),
              jnp.zeros((jrc.N_RECONFIG_STATS,), jnp.int32),
              jnp.zeros((jsim.kernels.N_SAFETY,), jnp.int32), jnp.int32(0)]
    tcarry = [tst, tsim.init_health(tcfg, "cpu"), trc.init_reconfig_state(tst),
              *trc._zero_accumulators("cpu"), torch.zeros((), dtype=torch.int32)]

    def runners(rounds):
        return (jap.make_cadence_runner(jcfg, jcomp, jcc, rounds, fused=fused,
                                        interpret=True),
                tap.make_cadence_runner(tcfg, tcomp, tcc, rounds, fused=fused))

    sched_args = jrunner.schedule_args(jcomp, jcc)
    return runners, sched_args, jcarry, tcarry, R


def assert_carry_equal(jout, tout, note):
    assert_states_equal(jout[0], tout[0], note)
    np.testing.assert_array_equal(tout[1].planes.numpy(), np.asarray(jout[1].planes),
                                  err_msg=f"{note}: health")
    assert tout[1].window_pos == int(jout[1].window_pos), note
    for f in trc.ReconfigState._fields:
        np.testing.assert_array_equal(getattr(tout[2], f).numpy(),
                                      np.asarray(getattr(jout[2], f)), err_msg=f"{note}: {f}")
    for i, name in ((3, "stats"), (4, "rstats"), (5, "safety"), (6, "commit stall")):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]),
                                      err_msg=f"{note}: {name}")
    assert int(tout[7]) == int(jout[7]), f"{note}: fused rounds"


def run_segments(G, cadence, fused, actions, **kw):
    """Both runners segment by segment; `actions(seg, tst)` gives each
    segment's (transfer [G], kick [P, G]) numpy planes.  Returns the
    fused counts of the segments."""
    runners, sched_args, jcarry, tcarry, R = _runner_pair(G, cadence, fused, **kw)
    built = {}
    fused_counts = []
    for seg, r0 in enumerate(range(0, R, cadence)):
        rounds = min(cadence, R - r0)
        if rounds not in built:
            built[rounds] = runners(rounds)
        jrun, trun = built[rounds]
        transfer, kick = actions(seg, tcarry[0])
        jout = jrun(*jcarry, jnp.int32(r0), jnp.asarray(transfer), jnp.asarray(kick),
                    *sched_args)
        tout = trun(*tcarry, r0, torch.from_numpy(transfer), torch.from_numpy(kick))
        assert_carry_equal(jout, tout, f"segment {seg} from round {r0}")
        jcarry, tcarry = list(jout[:7]), list(tout[:7])
        fused_counts.append(int(tout[7]))
    assert not tcarry[5].any(), "safety violations"
    return fused_counts


def autopilot_like_actions(G):
    def actions(seg, st):
        transfer = np.zeros(G, np.int32)
        kick = np.zeros((3, G), bool)
        lead = st.leader_id.amax(0).numpy()
        if seg == 0:
            transfer[::2] = (lead[::2] % 3) + 1  # to the next peer
        if seg == 1:
            kick[2, 1::2] = True
        return transfer, kick
    return actions


def test_cadence_runner_general_matches_jax():
    run_segments(8, 8, False, autopilot_like_actions(8))


def test_cadence_runner_refusals():
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, collect_health=True, transfer=True)
    comp = tap.empty_reconfig_schedule(8, 3, 4, "cpu")
    for bad, match in ((cfg._replace(collect_health=False), "collect_health"),
                       (cfg._replace(transfer=False), "transfer")):
        with pytest.raises(ValueError, match=match):
            tap.make_cadence_runner(bad, comp, None, 4)
    with pytest.raises(ValueError, match="reconfig schedule"):
        tap.make_cadence_runner(cfg, None, None, 4)
    with pytest.raises(ValueError, match="client plan"):
        tap.make_cadence_runner(cfg, comp, None, 4, client=object())
    with pytest.raises(NotImplementedError):
        tap.make_cadence_runner(cfg._replace(blackbox=True), comp, None, 4)
    run = tap.make_cadence_runner(cfg, comp, None, 4)
    st = tsim.init_state(cfg, device="cpu")
    carry = (st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st),
             *trc._zero_accumulators("cpu"), torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="overruns"):
        run(*carry, 6, torch.zeros(4, dtype=torch.int32),
            torch.zeros((3, 4), dtype=torch.bool))


# --- the closed loop end to end ----------------------------------------------------


def _run_both(on=True, balance=False, fused=False, G=8, cadence=5, plan=CRASH_PLAN,
              **cfg_kw):
    kw = dict(n_groups=G, n_peers=3, collect_health=True, transfer=True,
              commit_stall_ticks=8, **cfg_kw)
    apkw = dict(cadence=cadence, kick=on, transfer=on, kick_leaderless_ticks=2,
                balance=balance)
    append = None
    if balance:
        append = np.minimum(np.random.RandomState(0).zipf(1.8, size=G), 8).astype(np.int32)
    jmon, tmon = JMonitor(), HealthMonitor()
    js = JClusterSim(jsim.SimConfig(**kw), health_monitor=jmon)
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), health_monitor=tmon, device="cpu")
    want = jap.Autopilot(js, jap.AutopilotConfig(**apkw), fused=fused, interpret=True).run_plan(
        jchaos.plan_from_dict(plan), append=None if append is None else jnp.asarray(append))
    got = tap.Autopilot(ts, tap.AutopilotConfig(**apkw), fused=fused).run_plan(
        tchaos.plan_from_dict(plan), append=None if append is None else torch.from_numpy(append))
    assert got == want
    assert_states_equal(js.state, ts.state, "end state")
    np.testing.assert_array_equal(ts._health.planes.numpy(), np.asarray(js._health.planes))
    strip = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
             for e in jmon.summary_ring()]
    assert [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in tmon.summary_ring()] == strip
    assert "autopilot" in tmon.last()
    return got


@pytest.mark.parametrize("mode", ["on", "off", "balance"])
def test_run_plan_matches_jax(mode):
    rep = _run_both(on=mode != "off", balance=mode == "balance")
    assert not any(rep["safety"].values())
    if mode == "off":
        assert sum(rep["actions"].values()) == 0
    else:
        assert rep["actions"]["kicks"] > 0
    if mode == "balance":
        assert rep["actions"]["transfers"] > 0


def test_record_autopilot_matches_jax():
    class Trace:
        def __init__(self):
            self.events = []

        def trace(self, name, **fields):
            self.events.append((name, fields))

        def on_health_summary(self, summary):
            pass

    report = {"rounds": 10, "mttr_rounds": 2.0, "reelections": 3,
              "commit_stall_group_rounds": 7, "actions": {"kicks": 2},
              "safety": {"dual_leader": 1}}
    jm, tm = Trace(), Trace()
    want = JMonitor(metrics=jm).record_autopilot(report)
    mon = HealthMonitor(metrics=tm)
    got = mon.record_autopilot(report)
    assert got["autopilot"] is report and got["seq"] == want["seq"] == 0
    assert tm.events == jm.events
    assert [e[0] for e in tm.events] == ["autopilot.scenario", "autopilot.safety"]
    assert mon.last()["autopilot"] is report and len(mon) == 1


def test_new_entry_points_default_to_cuda():
    """Autopilot, make_cadence_runner and a transfer-on ClusterSim allocate
    on `cuda` unless told otherwise, and raise rather than fall back where
    there is no card; a black-box sim is refused."""
    cfg = tsim.SimConfig(4, 3, collect_health=True, transfer=True)
    plan = tchaos.plan_from_dict(CRASH_PLAN)
    calls = (lambda: tsim.ClusterSim(cfg),
             lambda: tap.make_cadence_runner(cfg, tap.empty_reconfig_schedule(42, 3, 4),
                                             None, 6),
             lambda: tap.Autopilot(tsim.ClusterSim(cfg)).run_plan(plan))
    if torch.cuda.is_available():
        sim = tsim.ClusterSim(cfg)
        assert sim.state.transferee.is_cuda
        tap.Autopilot(sim, tap.AutopilotConfig(cadence=6)).run_plan(plan)
        assert sim.state.term.is_cuda and sim._health.planes.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
    on_cpu = tsim.ClusterSim(cfg, device="cpu")
    assert on_cpu.state.transferee.device.type == "cpu"
    fake = _FakeSim(tsim, {})
    fake.cfg = fake.cfg._replace(blackbox=True)
    with pytest.raises(NotImplementedError):
        tap.Autopilot(fake)
    with pytest.raises(ValueError, match="no chaos plan"):
        tap.Autopilot(on_cpu).run_plan()
