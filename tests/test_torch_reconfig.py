"""The port's membership-change slice against the JAX package on the CPU,
exactly (every plane is int32 or bool):

  * `reconfig.compile_plan`, `initial_masks`, `HostReconfigSchedule` and
    `split_plan` give the reference's arrays and segments for every plan of
    tests/testdata/reconfig/plans.json and examples/reconfig/, at G=8 and a
    ragged G=13;
  * `kernels.apply_confchange` on random planes;
  * `sim.step(reconfig_propose=)` on the plain, the link-gated and the
    damped round, the proposal and the state every round;
  * `reconfig.make_runner` against the reference's on every plan of
    plans.json at G=8 and G=13, check_quorum off and on, with and without
    the plan's chaos overlay: the end state, health, op-protocol state, and
    the stats, rstats and safety accumulators;
  * the golden outputs of tests/testdata/reconfig/scenarios.txt through the
    harness of tests/test_reconfig_datadriven.py re-expressed on the port.

Kernel functions are looked up by name (getattr), so the JAX package's
parity-obligation baseline stays as it is."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.datadriven import TestData, run_test, walk
from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import assert_states_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "tests", "testdata")
with open(os.path.join(TESTDATA, "reconfig", "plans.json"), encoding="utf-8") as _f:
    PLANS = {d["name"]: d for d in json.load(_f)}


def _example(name):
    with open(os.path.join(ROOT, "examples", "reconfig", name), encoding="utf-8") as f:
        doc = json.load(f)
    return {"reconfig": doc.get("reconfig", doc), "chaos": doc.get("chaos")}


DOCS = dict(PLANS, **{n: _example(n + ".json") for n in ("joint_churn", "prod_fused")})


def kfn(mod, name):
    """A kernel function looked up by name (see the module docstring)."""
    return getattr(mod, name)


def assert_run_equal(jout, tout, note):
    """(state, health, rstate, stats, rstats, safety, ...) of both runners."""
    assert_states_equal(jout[0], tout[0], note)
    np.testing.assert_array_equal(tout[1].planes.numpy(), np.asarray(jout[1].planes),
                                  err_msg=f"{note}: health planes")
    assert tout[1].window_pos == int(jout[1].window_pos), note
    for f in jrc.ReconfigState._fields:
        w, g = np.asarray(getattr(jout[2], f)), getattr(tout[2], f).numpy()
        assert g.dtype == w.dtype, (note, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{note}: rstate {f}")
    for i, name in ((3, "stats"), (4, "rstats"), (5, "safety")):
        assert tout[i].dtype == torch.int32, (note, name)
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]),
                                      err_msg=f"{note}: {name}")


# --- the host-side schedule -------------------------------------------------


@pytest.mark.parametrize("G", [8, 13])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_compiled_schedule_matches_jax(name, G):
    doc = DOCS[name]
    jp, tp = jrc.plan_from_dict(doc["reconfig"]), trc.plan_from_dict(doc["reconfig"])
    jc, tc = jrc.compile_plan(jp, G), trc.compile_plan(tp, G, "cpu")
    for f in jrc.CompiledReconfig._fields:
        w, g = getattr(jc, f), getattr(tc, f)
        if f == "n_peers":
            assert g == w
            continue
        assert g.device.type == "cpu"
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert tc.n_rounds == jc.n_rounds == jp.n_rounds
    for w, g in zip(jrc.initial_masks(jp, G), trc.initial_masks(tp, G, "cpu")):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jh, th = jrc.HostReconfigSchedule(jp, G), trc.HostReconfigSchedule(tp, G)
    for f in ("phase_of_round", "append", "op_start", "n_ops", "tgt_voter",
              "tgt_outgoing", "tgt_learner", "added", "removed"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), err_msg=f)
    for g in range(G):
        for k in range(int(th.n_ops[g])):
            assert tuple(th.slot(g, k)) == tuple(jh.slot(g, k)), (g, k)
    jcc = tcc = None
    if doc["chaos"] is not None:
        jcc = jchaos.compile_plan(jchaos.plan_from_dict(doc["chaos"]), G)
        tcc = tchaos.compile_plan(tchaos.plan_from_dict(doc["chaos"]), G, "cpu")
    for k in (4, 8):
        for window in (2, 4):
            assert (trc.split_plan(tc, k, tcc, window)
                    == jrc.split_plan(jc, k, jcc, window)), (k, window)
            assert trc.split_plan(tc, k, None, window) == jrc.split_plan(jc, k, None, window)


@pytest.mark.parametrize("bad", [
    {"peers": 3, "phases": []},
    {"peers": 3, "phases": [{"rounds": 4}]},
    {"peers": 3, "phases": [{"rounds": 0, "op": {"add_voter": 2}}]},
    {"peers": 3, "voters": [1], "phases": [{"rounds": 4, "op": {"add_voter": 1}}]},
    {"peers": 3, "voters": [1], "phases": [{"rounds": 4, "op": {"add_voter": 4}}]},
    {"peers": 3, "phases": [{"rounds": 4, "op": {"leave_joint": False}}]},
    {"peers": 3, "phases": [{"rounds": 4, "op": {"leave_joint": True}}]},
    {"peers": 3, "phases": [{"rounds": 4, "op": {"enter_joint": []}}]},
    {"peers": 3, "phases": [{"rounds": 4, "op": {"promote_learner": 2}}]},
    {"peers": 3, "phases": [{"rounds": 4, "op": {"add_voter": 2, "remove_voter": 1}}]},
], ids=lambda d: json.dumps(d["phases"][0]["op"]) if d["phases"] and "op" in d["phases"][0] else "no-op")
def test_bad_plans_raise_as_in_jax(bad):
    """The plan checks and the Changer's own refusals give the reference's
    error type and message."""
    with pytest.raises(Exception) as want:
        jrc.compile_plan(jrc.plan_from_dict(bad), 4)
    with pytest.raises(Exception) as got:
        trc.compile_plan(trc.plan_from_dict(bad), 4, "cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# --- apply_confchange and step(reconfig_propose=) ---------------------------


@pytest.mark.parametrize("with_ra", [False, True], ids=["undamped", "recent_active"])
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_confchange_matches_jax(seed, P, with_ra):
    G = 16
    rng = np.random.default_rng(seed * 10 + P)

    def b(p, shape=(P, G)):
        return rng.random(shape) < p

    def i(hi, shape=(P, G)):
        return rng.integers(0, hi, shape).astype(np.int32)

    matched = i(30, (P, P, G))
    # state, leader_id, commit and term_start_index (both low, so that pickups
    # happen), matched, the masks, the targets, the deltas, apply_mask.
    args = [i(4), i(P + 1), i(12), i(6), matched, b(0.6), b(0.3), b(0.2),
            b(0.6), b(0.3), b(0.2), b(0.2), b(0.2), b(0.7, (G,))]
    ra = b(0.5, (P, P, G)) if with_ra else None
    want = kfn(jk, "apply_confchange")(*(jnp.asarray(a) for a in args),
                                 None if ra is None else jnp.asarray(ra))
    got = kfn(tk, "apply_confchange")(*(torch.from_numpy(a) for a in args),
                                None if ra is None else torch.from_numpy(ra))
    assert (got[7] is None) == (ra is None) and got[8] is None and want[8] is None
    for n, (w, g) in enumerate(zip(want[:8], got[:8])):
        if w is None:
            continue
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, n
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {n}")
    # The pickup branch and the step-down branch both fire somewhere.
    assert (np.asarray(want[2]) != args[2]).any()
    assert (np.asarray(want[0]) != args[0]).any()


def test_apply_confchange_refuses_the_transferee_plane():
    """The transferee arm is ported: with no pending transfer the plane
    comes back as it was (all zero), the other outputs unchanged."""
    P, G = 3, 4
    z = torch.zeros((P, G), dtype=torch.int32)
    m = torch.zeros((P, G), dtype=torch.bool)
    args = (z, z, z, z, torch.zeros((P, P, G), dtype=torch.int32),
            m, m, m, m, m, m, m, m, torch.ones(G, dtype=torch.bool), None)
    bare = kfn(tk, "apply_confchange")(*args)
    out = kfn(tk, "apply_confchange")(*args, z)
    assert bare[8] is None and torch.equal(out[8], z)
    assert all(torch.equal(a, b) for a, b in zip(bare[:7], out[:7]))


@pytest.mark.parametrize("kind", ["plain", "linked", "damped"])
def test_step_reconfig_propose_matches_jax(kind):
    """40 rounds from init_state with random proposal masks, the append
    workload plus the conf entry, and a crashed peer now and then: the
    reported ReconfigProposal and the whole state every round, with and
    without the health extra."""
    G, P, rounds = 12, 3, 40
    kw = dict(n_groups=G, n_peers=P, collect_health=True,
              check_quorum=kind == "damped", pre_vote=kind == "damped")
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    rng = np.random.default_rng(7)
    jst, tst = jsim.init_state(jcfg), tsim.init_state(tcfg, device="cpu")
    jh, th = jsim.init_health(jcfg), tsim.init_health(tcfg, "cpu")
    jstep = jax.jit(lambda s, c, a, h, l, p: jsim.step(
        jcfg, s, c, a, health=h, link=l, reconfig_propose=p))
    jstep_bare = jax.jit(lambda s, c, a, l, p: jsim.step(
        jcfg, s, c, a, link=l, reconfig_propose=p))
    owners = 0
    for r in range(rounds):
        crashed = np.zeros((P, G), bool)
        if r % 7 == 3:
            crashed[r % P, ::3] = True
        prop = rng.random(G) < 0.5
        append = (1 + prop).astype(np.int32)
        link = None
        if kind == "linked":
            link = rng.random((P, P, G)) < 0.95
        jl = None if link is None else jnp.asarray(link)
        tl = None if link is None else torch.from_numpy(link)
        args_j = (jnp.asarray(crashed), jnp.asarray(append))
        args_t = (torch.from_numpy(crashed), torch.from_numpy(append))
        if r % 2:
            jst, jh, jp = jstep(jst, *args_j, jh, jl, jnp.asarray(prop))
            tst, th, tp = tsim.step(tcfg, tst, *args_t, health=th, link=tl,
                                    reconfig_propose=torch.from_numpy(prop))
            np.testing.assert_array_equal(th.planes.numpy(), np.asarray(jh.planes))
        else:
            jst, jp = jstep_bare(jst, *args_j, jl, jnp.asarray(prop))
            tst, tp = tsim.step(tcfg, tst, *args_t, link=tl,
                                reconfig_propose=torch.from_numpy(prop))
        assert isinstance(tp, tsim.ReconfigProposal)
        for f in tsim.ReconfigProposal._fields:
            g, w = getattr(tp, f), np.asarray(getattr(jp, f))
            assert g.dtype == torch.int32, f
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"round {r} {f}")
        assert_states_equal(jst, tst, f"round {r}")
        owners += int((tp.owner > 0).sum())
    assert owners > rounds * G // 4


def test_reconfig_entry_points_default_to_cuda():
    """compile_plan, initial_masks and ClusterSim.run_reconfig's sim
    allocate on `cuda` unless told otherwise, and raise rather than fall
    back where there is no card."""
    plan = trc.plan_from_dict(PLANS["promote_learner_lossy"]["reconfig"])
    cfg = tsim.SimConfig(4, 3, collect_health=True)
    calls = (lambda: trc.compile_plan(plan, 4), lambda: trc.initial_masks(plan, 4),
             lambda: tsim.ClusterSim(cfg).run_reconfig(plan))
    if torch.cuda.is_available():
        assert trc.compile_plan(plan, 4).op_start.is_cuda
        assert all(m.is_cuda for m in trc.initial_masks(plan, 4))
        sim = tsim.ClusterSim(cfg, *trc.initial_masks(plan, 4))
        sim.run_reconfig(plan)
        assert sim._reconfig_state.op_ptr.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
    with pytest.raises(ValueError):  # not the plan's bootstrap masks
        tsim.ClusterSim(cfg, device="cpu").run_reconfig(plan)


# --- the whole-plan runner -------------------------------------------------


def _fresh(sim_mod, rc_mod, cfg, plan, G, device=None):
    masks = (rc_mod.initial_masks(plan, G) if device is None
             else rc_mod.initial_masks(plan, G, device))
    if device is None:
        st = sim_mod.init_state(cfg, *masks)
        return st, sim_mod.init_health(cfg), rc_mod.init_reconfig_state(st)
    st = sim_mod.init_state(cfg, *masks, device=device)
    return st, sim_mod.init_health(cfg, device), rc_mod.init_reconfig_state(st)


@pytest.mark.parametrize("with_chaos", [False, True], ids=["bare", "chaos"])
@pytest.mark.parametrize("cq", [False, True], ids=["undamped", "check_quorum"])
@pytest.mark.parametrize("G", [8, 13])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_make_runner_matches_jax(name, G, cq, with_chaos):
    doc = PLANS[name]
    kw = dict(n_groups=G, n_peers=3, collect_health=True, health_window=8,
              check_quorum=cq)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    jp, tp = jrc.plan_from_dict(doc["reconfig"]), trc.plan_from_dict(doc["reconfig"])
    jcc = tcc = None
    if with_chaos:
        jcc = jchaos.compile_plan(jchaos.plan_from_dict(doc["chaos"]), G)
        tcc = tchaos.compile_plan(tchaos.plan_from_dict(doc["chaos"]), G, "cpu")
    want = jrc.make_runner(jcfg, jrc.compile_plan(jp, G), jcc)(
        *_fresh(jsim, jrc, jcfg, jp, G))
    got = trc.make_runner(tcfg, trc.compile_plan(tp, G, "cpu"), tcc)(
        *_fresh(tsim, trc, tcfg, tp, G, "cpu"))
    assert_run_equal(want, got, f"{name} G={G} cq={cq} chaos={with_chaos}")
    assert int(got[4][trc.RC_PROPOSED]) >= int(got[4][trc.RC_APPLIED]) > 0


def test_run_plan_defaults_and_runner_checks():
    doc = PLANS["promote_learner_lossy"]
    G = 8
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True, health_window=8)
    plan = trc.plan_from_dict(doc["reconfig"])
    compiled = trc.compile_plan(plan, G, "cpu")
    st = tsim.init_state(cfg, *trc.initial_masks(plan, G, "cpu"), device="cpu")
    out = trc.run_plan(cfg, st, compiled)
    want = trc.make_runner(cfg, compiled)(*_fresh(tsim, trc, cfg, plan, G, "cpu"))
    for a, b in zip(out, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert_states_equal(_as_jax_like(want[0]), out[0])
    with pytest.raises(ValueError):
        trc.make_runner(cfg._replace(n_peers=5), compiled)
    with pytest.raises(ValueError):
        trc.make_runner(cfg._replace(n_groups=9), compiled)
    short = tchaos.compile_plan(tchaos.plan_from_dict(
        {"peers": 3, "phases": [{"rounds": 5}]}), G, "cpu")
    with pytest.raises(ValueError):
        trc.make_runner(cfg, compiled, short)
    # The actions arm is ported; its zero planes need the transferee plane.
    body = trc._runner_body(cfg, compiled, None, actions=(
        0, torch.zeros(G, dtype=torch.int32), torch.zeros((3, G), dtype=torch.bool)))
    with pytest.raises(ValueError, match="transfer"):
        body((st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st))
             + trc._zero_accumulators("cpu"), 0)
    with pytest.raises(NotImplementedError):
        trc.make_runner(cfg._replace(blackbox=True), compiled)


def _as_jax_like(st):
    """A SimState of numpy planes, which assert_states_equal reads as the
    reference side."""
    return tsim.SimState(*(None if v is None else v.numpy() for v in st))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconfig_stall_groups_rank_as_jax(seed):
    """The stall rule and its ranking (ties included) on random planes."""
    rng = np.random.default_rng(seed)
    om = rng.random((3, 40)) < 0.3
    since = rng.integers(0, 60, 40).astype(np.int32)
    for timeouts, topk in ((4, 8), (2, 5), (1, 40)):
        assert (HealthMonitor.reconfig_stall_groups(om, since, 10, timeouts, topk)
                == JMonitor.reconfig_stall_groups(om, since, 10, timeouts, topk))


class _Trace:
    def __init__(self):
        self.events = []

    def on_health_summary(self, summary):
        pass

    def trace(self, event, **fields):
        self.events.append((event, fields))


def test_run_reconfig_reports_stalled_groups_as_jax():
    """ClusterSim.run_reconfig on the plan whose joint exit a downed
    outgoing majority blocks, with its chaos overlay: the report (stalled
    groups and the worst ones included) equals the JAX package's, and the
    monitor traces the scenario and the stall."""
    doc = PLANS["joint_exit_blocked"]
    G = 8
    kw = dict(n_groups=G, n_peers=3, collect_health=True, health_window=8,
              election_tick=5)
    jp, tp = jrc.plan_from_dict(doc["reconfig"]), trc.plan_from_dict(doc["reconfig"])
    jsm = jsim.ClusterSim(jsim.SimConfig(**kw), *jrc.initial_masks(jp, G))
    mon = HealthMonitor(metrics=_Trace())
    tsm = tsim.ClusterSim(tsim.SimConfig(**kw), *trc.initial_masks(tp, G, "cpu"),
                          health_monitor=mon, device="cpu")
    want = jsm.run_reconfig(jp, jchaos.plan_from_dict(doc["chaos"]))
    got = tsm.run_reconfig(tp, tchaos.plan_from_dict(doc["chaos"]))
    assert got == want
    assert got["reconfig_stalled_groups"] > 0 and got["reconfig_stalled_worst"]
    assert_states_equal(jsm.state, tsm.state, "joint_exit_blocked")
    assert [e for e, _ in mon.metrics.events] == ["reconfig.scenario",
                                                  "health.reconfig_stall"]
    assert mon.last()["reconfig"] == got


# --- the golden corpus ------------------------------------------------------


GG, GP, GWINDOW = 8, 3, 8


class PortReconfigHarness:
    """tests/test_reconfig_datadriven.py's harness on the port: the host
    schedules, the step with the health planes, the link plane and the
    proposal mask, and the gate and apply per round on host arrays, with the
    port's apply_confchange and check_safety."""

    def __init__(self):
        self.cfg = tsim.SimConfig(n_groups=GG, n_peers=GP, collect_health=True,
                                  health_window=GWINDOW)

    def handle(self, td: TestData) -> str:
        if td.cmd != "run":
            raise ValueError(f"unknown command {td.cmd}")
        doc = PLANS[td.arg("plan").value]
        plan = trc.plan_from_dict(doc["reconfig"])
        sched = trc.HostReconfigSchedule(plan, GG)
        csched = tchaos.HostSchedule(tchaos.plan_from_dict(doc["chaos"]), GG)
        assert csched.n_rounds == sched.n_rounds
        compiled = trc.compile_plan(plan, GG, "cpu")
        st = tsim.init_state(self.cfg, *trc.initial_masks(plan, GG, "cpu"), device="cpu")
        hl = tsim.init_health(self.cfg, "cpu")
        rst = trc.init_reconfig_state(st)
        safety = np.zeros(tk.N_SAFETY, np.int64)
        rstats = np.zeros(trc.N_RECONFIG_STATS, np.int64)
        gi = np.arange(GG)
        for r in range(sched.n_rounds):
            link, crashed, capp = csched.masks(r)
            append = sched.append[int(sched.phase_of_round[r])] + capp
            op_ptr = rst.op_ptr.numpy()
            start = sched.op_start[np.clip(op_ptr, 0, sched.op_start.shape[0] - 1), gi]
            want = (op_ptr < sched.n_ops) & (r >= start) & (rst.stage.numpy() == 0)
            crashed_t = torch.from_numpy(crashed)
            st2, hl, prop = tsim.step(
                self.cfg, st, crashed_t, torch.from_numpy((append + want).astype(np.int32)),
                health=hl, link=torch.from_numpy(link),
                reconfig_propose=torch.from_numpy(want),
            )
            got = want & (prop.owner.numpy() > 0)
            stage = np.where(got, 1, rst.stage.numpy())
            powner = np.where(got, prop.owner.numpy(), rst.prop_owner.numpy())
            pindex = np.where(got, prop.index.numpy(), rst.prop_index.numpy())
            pterm = np.where(got, prop.term.numpy(), rst.prop_term.numpy())
            o = np.clip(powner - 1, 0, GP - 1)
            own_lead = ((st2.state.numpy()[o, gi] == tk.ROLE_LEADER)
                        & (st2.term.numpy()[o, gi] == pterm) & ~crashed[o, gi])
            apply_mask = (stage == 1) & own_lead & (st2.commit.numpy()[o, gi] >= pindex)
            retry = (stage == 1) & ~own_lead
            stage = np.where(apply_mask | retry, 0, stage)
            safety += kfn(tk, "check_safety")(
                st2.state, st2.term, st2.commit, st2.last_index, st2.agree, st.commit,
                voter_mask=st2.voter_mask, outgoing_mask=st2.outgoing_mask,
                matched=st2.matched, crashed=crashed_t,
                prev_voter_mask=rst.prev_voter, prev_outgoing_mask=rst.prev_outgoing,
            ).numpy()
            ptr = torch.from_numpy(op_ptr)
            (state3, leader3, commit3, matched3, vm3, om3, lm3, _, _) = (
                kfn(tk, "apply_confchange")(
                    st2.state, st2.leader_id, st2.commit, st2.term_start_index,
                    st2.matched, st2.voter_mask, st2.outgoing_mask, st2.learner_mask,
                    *(trc._gather_op(getattr(compiled, f), ptr) for f in (
                        "tgt_voter", "tgt_outgoing", "tgt_learner", "added",
                        "removed")),
                    torch.from_numpy(apply_mask), None,
                ))
            rstats += np.asarray([got.sum(), apply_mask.sum(), retry.sum(),
                                  int(om3.any(0).sum())])
            rst = trc.ReconfigState(
                stage=torch.from_numpy(stage.astype(np.int32)),
                op_ptr=torch.from_numpy(np.where(apply_mask, op_ptr + 1, op_ptr)
                                        .astype(np.int32)),
                prop_owner=torch.from_numpy(powner.astype(np.int32)),
                prop_index=torch.from_numpy(pindex.astype(np.int32)),
                prop_term=torch.from_numpy(pterm.astype(np.int32)),
                prev_voter=st2.voter_mask, prev_outgoing=st2.outgoing_mask,
            )
            st = st2._replace(state=state3, leader_id=leader3, commit=commit3,
                              matched=matched3, voter_mask=vm3, outgoing_mask=om3,
                              learner_mask=lm3)
        safety += kfn(tk, "check_safety")(
            st.state, st.term, st.commit, st.last_index, st.agree, st.commit,
            voter_mask=st.voter_mask, outgoing_mask=st.outgoing_mask,
            matched=st.matched, prev_voter_mask=rst.prev_voter,
            prev_outgoing_mask=rst.prev_outgoing,
        ).numpy()
        planes = hl.planes.numpy()
        out = [f"{name}: {' '.join(str(v) for v in planes[i])}"
               for i, name in enumerate(tk.HEALTH_PLANE_NAMES)]

        def cols(mask):
            return " ".join("".join(str(int(v)) for v in mask.numpy()[:, g])
                            for g in range(GG))

        out += [
            "leaders: " + " ".join(str(v) for v in
                                   (st.state.numpy() == tk.ROLE_LEADER).sum(0)),
            "max_term: " + " ".join(str(v) for v in st.term.numpy().max(0)),
            "commit: " + " ".join(str(v) for v in st.commit.numpy().max(0)),
            "voters: " + cols(st.voter_mask),
            "learners: " + cols(st.learner_mask),
            "joint: " + " ".join(str(int(v)) for v in st.outgoing_mask.numpy().any(0)),
            "op_ptr: " + " ".join(str(v) for v in rst.op_ptr.numpy()),
            "reconfig: " + " ".join(f"{k}={v}" for k, v in
                                    zip(trc.RECONFIG_STAT_NAMES, rstats)),
            "safety: " + " ".join(f"{k}={v}" for k, v in zip(tk.SAFETY_NAMES, safety)),
        ]
        assert not safety.any(), f"{td.pos}: safety violations {safety}"
        return "\n".join(out) + "\n"


def test_reconfig_goldens_replay_through_the_port():
    harness = PortReconfigHarness()
    ran = []

    def run(path):
        run_test(path, harness.handle, rewrite=False)
        ran.append(os.path.basename(path))

    walk(os.path.join(TESTDATA, "reconfig"), run)
    assert ran == ["scenarios.txt"]
