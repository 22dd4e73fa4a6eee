"""This slice's split-horizon runner end to end against the JAX package on
the CPU, exactly: the port's `reconfig.make_split_runner` against the
reference's (`interpret=True`: its fused blocks run the Pallas kernels in
interpret mode, a k=8 build each), on

  * an undamped G=8 plan with a mid-horizon promotion (the boot storm
    rejects the early blocks, the settled ones fuse);
  * a check-quorum G=8 plan with a joint window that adds a voter;
  * the production overlay at G=16, cut to 56 rounds after a 36-round
    settle: health, counters, a lossy chaos phase, check-quorum, pre-vote
    and three ops (bench.py --prod-fused's composition), and the whole of
    examples/reconfig/prod_fused.json after bench.py's 192-round settle
    (slow);

the end state, health, op-protocol state, the stats, rstats and safety
accumulators, the fused group-round count, the segments and the counters.
Then, in the port alone, the split runner against the unsplit one, and
`ClusterSim.run_reconfig(split=True)` against `split=False` and against the
JAX package's report."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

from test_torch_reconfig import assert_run_equal, kfn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROD = os.path.join(ROOT, "examples", "reconfig", "prod_fused.json")
K = 8

UNDAMPED_PLAN = {
    "name": "split-undamped", "peers": 3, "voters": [1, 2], "learners": [3],
    "phases": [{"rounds": 24, "append": 1},
               {"rounds": 8, "append": 1, "op": {"promote_learner": 3}},
               {"rounds": 32, "append": 1}],
}
CQ_PLAN = {
    "name": "split-cq", "peers": 3, "voters": [1, 2], "learners": [3],
    "phases": [{"rounds": 40, "append": 1},
               {"rounds": 8, "append": 1, "op": {"enter_joint": [{"add": 3}]}},
               {"rounds": 8, "append": 1, "op": {"leave_joint": True}},
               {"rounds": 32, "append": 1}],
}
# bench.py --prod-fused's composition (examples/reconfig/prod_fused.json)
# cut to 56 rounds after a 36-round settle at election_tick 12.
PROD_CUT = {
    "reconfig": {
        "name": "prod-cut", "peers": 5, "voters": [1, 2, 3], "learners": [4, 5],
        "phases": [{"rounds": 16, "append": 1},
                   {"rounds": 8, "append": 1, "op": {"promote_learner": 4}},
                   {"rounds": 8, "append": 1, "op": {"enter_joint": [{"add": 5}]}},
                   {"rounds": 8, "append": 1, "op": {"leave_joint": True}},
                   {"rounds": 16, "append": 1}],
    },
    "chaos": {
        "name": "prod-cut-chaos", "peers": 5,
        "phases": [{"rounds": 32}, {"rounds": 8, "loss_all": 0.02},
                   {"rounds": 16, "heal": True}],
    },
}
PROD_CUT_KW = dict(election_tick=12, check_quorum=True, pre_vote=True)


def _both(doc, G, settle=0, chaos_doc=None, **cfg_kw):
    """(JAX side, port side), each (cfg, compiled, chaos compiled, start
    state): init_state from the plan's bootstrap masks, then `settle` steps
    with one append a group (bench_prod_fused's settle)."""
    out = []
    for sim, rc, ch, dev in ((jsim, jrc, jchaos, None), (tsim, trc, tchaos, "cpu")):
        kw = dict(n_groups=G, n_peers=doc["peers"], collect_health=True, **cfg_kw)
        cfg = sim.SimConfig(**kw)
        plan = rc.plan_from_dict(doc)
        cc = None
        if dev is None:
            compiled = rc.compile_plan(plan, G)
            st = sim.init_state(cfg, *rc.initial_masks(plan, G))
            if chaos_doc is not None:
                cc = ch.compile_plan(ch.plan_from_dict(chaos_doc), G)
            step = jax.jit(lambda s, c, a, cfg=cfg: sim.step(cfg, s, c, a))
            crashed, append = jnp.zeros((doc["peers"], G), bool), jnp.ones((G,), jnp.int32)
        else:
            compiled = rc.compile_plan(plan, G, dev)
            st = sim.init_state(cfg, *rc.initial_masks(plan, G, dev), device=dev)
            if chaos_doc is not None:
                cc = ch.compile_plan(ch.plan_from_dict(chaos_doc), G, dev)
            step = lambda s, c, a, cfg=cfg: sim.step(cfg, s, c, a)  # noqa: E731
            crashed = torch.zeros((doc["peers"], G), dtype=torch.bool)
            append = torch.ones(G, dtype=torch.int32)
        for _ in range(settle):
            st = step(st, crashed, append)
        out.append((cfg, compiled, cc, st))
    return out


def _split_pair(doc, G, settle=0, chaos_doc=None, with_counters=False, **cfg_kw):
    (jcfg, jc, jcc, jst), (tcfg, tc, tcc, tst) = _both(
        doc, G, settle, chaos_doc, **cfg_kw)
    jr = jrc.make_split_runner(jcfg, jc, jcc, k=K, window=4,
                               with_counters=with_counters, interpret=True)
    tr = trc.make_split_runner(tcfg, tc, tcc, k=K, window=4,
                               with_counters=with_counters)
    jextra = (kfn(jk, "zero_counters")(),) if with_counters else ()
    textra = (kfn(tk, "zero_counters")("cpu"),) if with_counters else ()
    want = jr(jst, jsim.init_health(jcfg), jrc.init_reconfig_state(jst), *jextra)
    got = tr(tst, tsim.init_health(tcfg, "cpu"), trc.init_reconfig_state(tst), *textra)
    assert tr.segments == jr.segments
    assert_run_equal(want, got, doc["name"])
    assert isinstance(got[6], int) and got[6] == int(want[6])
    # One (first round, fused) pair for each planned block, in order.
    assert [r0 for r0, _ in tr.blocks] == [
        r0 for seg in tr.segments if seg.fused
        for r0 in range(seg.start, seg.start + seg.rounds, K)]
    assert sum(ran for _, ran in tr.blocks) * K * G == got[6]
    if with_counters:
        assert got[7].dtype == torch.int32
        np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    assert not got[5].any(), "safety violations"
    total = trc.compile_plan(trc.plan_from_dict(doc), G, "cpu").n_rounds * G
    assert 0 < got[6] < total, (got[6], total)
    return got, tr


def test_split_runner_matches_jax_undamped_g8():
    got, _ = _split_pair(UNDAMPED_PLAN, 8)
    assert (got[2].op_ptr == 1).all()


def test_split_runner_matches_jax_check_quorum_g8():
    got, _ = _split_pair(CQ_PLAN, 8, election_tick=16, check_quorum=True)
    assert (got[2].op_ptr == 2).all()


def test_split_runner_matches_jax_prod_overlay_g16():
    got, runner = _split_pair(
        PROD_CUT["reconfig"], 16, settle=36, chaos_doc=PROD_CUT["chaos"],
        with_counters=True, collect_counters=True, **PROD_CUT_KW)
    assert (got[2].op_ptr == 3).all()
    assert any(s.fused for s in runner.segments)


@pytest.mark.slow
def test_split_runner_matches_jax_prod_fused_json_g16():
    """bench.py --prod-fused examples/reconfig/prod_fused.json at G=16:
    election_tick 64, the 192-round settle, k=8, window 4, counters."""
    with open(PROD, encoding="utf-8") as f:
        doc = json.load(f)
    _split_pair(doc["reconfig"], 16, settle=192, chaos_doc=doc["chaos"],
                with_counters=True, election_tick=64, collect_counters=True,
                check_quorum=True, pre_vote=True)


# --- the port alone: split against unsplit ---------------------------------


@pytest.mark.parametrize("case", ["undamped", "check_quorum", "prod"])
def test_split_runner_matches_unsplit(case):
    doc, G, settle, chaos_doc, kw = {
        "undamped": (UNDAMPED_PLAN, 12, 0, None, {}),
        "check_quorum": (CQ_PLAN, 12, 0, None,
                         dict(election_tick=16, check_quorum=True)),
        "prod": (PROD_CUT["reconfig"], 12, 36, PROD_CUT["chaos"], PROD_CUT_KW),
    }[case]
    cfg, compiled, cc, st = _both(doc, G, settle, chaos_doc, **kw)[1]
    unsplit = trc.make_runner(cfg, compiled, cc)(
        st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st))
    runner = trc.make_split_runner(cfg, compiled, cc, k=K, window=4)
    split = runner(st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st))
    jax_like = tuple(
        tsim.SimState(*(None if v is None else v.numpy() for v in x))
        if i == 0 else (
            tsim.HealthState(x.planes.numpy(), x.window_pos) if i == 1 else (
                trc.ReconfigState(*(v.numpy() for v in x)) if i == 2 else x.numpy()))
        for i, x in enumerate(unsplit))
    assert_run_equal(jax_like, split, f"{case}: split vs unsplit")
    assert 0 < split[6] < compiled.n_rounds * G


def test_split_runner_guards():
    cfg, compiled, _, st = _both(UNDAMPED_PLAN, 8)[1]
    with pytest.raises(ValueError):
        trc.make_split_runner(cfg._replace(collect_health=False), compiled)
    with pytest.raises(ValueError):
        trc.make_split_runner(cfg._replace(blackbox=True), compiled)
    with pytest.raises(ValueError):
        trc.make_split_runner(cfg, compiled, k=cfg.health_window + 8)
    with pytest.raises(ValueError):
        trc.make_split_runner(cfg._replace(n_peers=5), compiled)
    runner = trc.make_split_runner(cfg, compiled, with_counters=True)
    with pytest.raises(ValueError):
        runner(st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st))


# --- ClusterSim.run_reconfig ---------------------------------------------------


class Trace:
    """A metrics stand-in recording trace events and the stall gauge."""

    def __init__(self):
        self.events = []
        self.stalled = None
        trace = self

        class Gauge:
            def set(self, v):
                trace.stalled = v

        self.health_reconfig_stalled = Gauge()

    def on_health_summary(self, summary):
        pass

    def trace(self, event, **fields):
        self.events.append((event, fields))


def test_run_reconfig_split_reports_match_jax_and_unsplit():
    """ClusterSim.run_reconfig(split=True) against the JAX package's
    (counters and health on: the counter plane threads through the split
    run and drains into the host totals) and against split=False."""
    G = 8
    doc = UNDAMPED_PLAN
    kw = dict(n_groups=G, n_peers=3, collect_health=True, collect_counters=True)
    jplan, tplan = jrc.plan_from_dict(doc), trc.plan_from_dict(doc)
    jsm = jsim.ClusterSim(jsim.SimConfig(**kw), *jrc.initial_masks(jplan, G),
                          health_monitor=JMonitor())
    mon = HealthMonitor(metrics=Trace())
    tsm = tsim.ClusterSim(tsim.SimConfig(**kw), *trc.initial_masks(tplan, G, "cpu"),
                          health_monitor=mon, device="cpu")
    want, got = jsm.run_reconfig(jplan, split=True), tsm.run_reconfig(tplan, split=True)
    assert got == want
    assert got["total_rounds"] == 64 * G and 0 < got["fused_rounds"] < 64 * G
    assert got["fused_frac"] == round(got["fused_rounds"] / got["total_rounds"], 4)
    assert got["ops_applied"] == G and not any(got["safety"].values())
    from test_torch_sim import assert_states_equal

    assert_states_equal(jsm.state, tsm.state, "run_reconfig split")
    np.testing.assert_array_equal(tsm._health.planes.numpy(), np.asarray(jsm._health.planes))
    assert tsm.counters() == jsm.counters()
    assert tsm._rounds_since_drain == 0 and int(tsm._counters.sum()) == 0
    assert mon.last()["reconfig"] == got
    assert [e for e, _ in mon.metrics.events] == ["reconfig.scenario"]
    assert mon.metrics.stalled == 0
    unsplit = tsim.ClusterSim(tsim.SimConfig(**kw), *trc.initial_masks(tplan, G, "cpu"),
                              device="cpu")
    base = unsplit.run_reconfig(tplan)
    assert base == {k: v for k, v in got.items()
                    if k not in ("fused_rounds", "total_rounds", "fused_frac")}
    assert_states_equal(jsm.state, unsplit.state, "run_reconfig unsplit")
