"""This slice's fused client-workload runner end to end against the JAX
package on the CPU, exactly: the port's `workload.make_split_runner` against
the reference's (`interpret=True`: its fused blocks run the Pallas kernels
in interpret mode, a k=8 build each) on

  * a check-quorum lease config at G=8 (tests/test_workload.py's split
    fixture: a pure-lease phase that fuses, a Safe phase whose blocks all
    fall back, a quiet tail), the damped kernel's with_health instance;
  * an undamped config at G=8 (a read-free stretch that fuses, lease reads
    that degrade and never fuse, Safe reads), the steady kernel's
    with_health instance;
  * examples/reads/zipf_mixed.json at G=16 after bench.py --reads' 192-round
    settle (slow);

every output and the fused group-round count.  Then
`ClusterSim.run_reads(split=True)` against `split=False` and against the
JAX package's report."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft import workload as jwl
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import assert_states_equal
from test_torch_workload import assert_workload_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZIPF_MIXED = os.path.join(ROOT, "examples", "reads", "zipf_mixed.json")
K = 8

# tests/test_workload.py's split_plan_fixture.
CQ_PLAN = {"name": "split", "peers": 3, "phases": [
    {"rounds": 24, "append": 1, "read_every": 2, "read_mode": "lease"},
    {"rounds": 16, "append": 1, "read_every": 4, "read_mode": "safe"},
    {"rounds": 8, "append": 1}]}
UNDAMPED_PLAN = {"name": "split-undamped", "peers": 3, "seed": 3, "phases": [
    {"rounds": 16, "write_zipf": 1.8, "write_max": 4},
    {"rounds": 16, "append": 1, "read_every": 2, "read_mode": "lease"},
    {"rounds": 12, "append": 1, "read_every": 3, "read_mode": "safe",
     "groups": {"mod": 2, "eq": 0}},
    {"rounds": 16, "append": 2},
    {"rounds": 3, "append": 1}]}
CQ_KW = dict(election_tick=16, check_quorum=True, lease_read=True)


def _settled_pair(G, P, settle, **cfg_kw):
    """(JAX cfg, port cfg, JAX state, port state) after `settle` rounds of
    one append a group from init_state."""
    kw = dict(n_groups=G, n_peers=P, collect_health=True, **cfg_kw)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    jst, tst = jsim.init_state(jcfg), tsim.init_state(tcfg, device="cpu")
    step = jax.jit(lambda s, c, a: jsim.step(jcfg, s, c, a))
    for _ in range(settle):
        jst = step(jst, jnp.zeros((P, G), bool), jnp.ones((G,), jnp.int32))
        tst = tsim.step(tcfg, tst, torch.zeros((P, G), dtype=torch.bool),
                        torch.ones(G, dtype=torch.int32))
    assert_states_equal(jst, tst, "settle")
    return jcfg, tcfg, jst, tst


def _split_pair(doc, G, settle, **cfg_kw):
    """Both split runners over `doc` from the settled pair: the port's
    outputs (checked equal to the reference's) and its runner."""
    jcfg, tcfg, jst, tst = _settled_pair(G, doc["peers"], settle, **cfg_kw)
    jp, tp = jwl.plan_from_dict(doc), twl.plan_from_dict(doc)
    jr = jwl.make_split_runner(jcfg, jwl.compile_plan(jp, G), k=K, interpret=True)
    tr = twl.make_split_runner(tcfg, twl.compile_plan(tp, G, "cpu"), k=K)
    want = jr(jst, jsim.init_health(jcfg), jrc.init_reconfig_state(jst),
              jwl.init_read_carry(G))
    got = tr(tst, tsim.init_health(tcfg, "cpu"), trc.init_reconfig_state(tst),
             twl.init_read_carry(G, "cpu"))
    assert_workload_equal(want, got, doc["name"])
    assert isinstance(got[9], int) and got[9] == int(want[9])
    assert [r0 for r0, _ in tr.blocks] == list(range(0, tp.n_rounds - K + 1, K))
    assert sum(ran for _, ran in tr.blocks) * K * G == got[9]
    assert not got[5].any(), "safety violations"
    return got, tr, (tcfg, tst)


def test_split_runner_matches_jax_check_quorum():
    got, tr, _ = _split_pair(CQ_PLAN, 8, 48, **CQ_KW)
    # The pure-lease phase fused, the Safe phase's blocks all fell back.
    assert [ran for _, ran in tr.blocks] == [True, True, True, False, False, True]
    rd = got[7]
    assert rd[twl.RS_SERVED_LEASE] > 0 and rd[twl.RS_SERVED_QUORUM] > 0


def test_split_runner_matches_jax_undamped():
    got, tr, _ = _split_pair(UNDAMPED_PLAN, 8, 30)
    ran = [r for _, r in tr.blocks]
    # Undamped lease requests degrade, so only read-free blocks fuse.
    assert ran[:2] == [True, True] and ran[2:4] == [False, False] and any(ran[4:])
    assert got[7][twl.RS_SERVED_LEASE] == 0 and got[7][twl.RS_DEGRADED_SERVES] > 0


@pytest.mark.slow
def test_zipf_mixed_json_matches_jax_g16():
    """examples/reads/zipf_mixed.json as bench.py --reads runs it: the
    production damped config (check_quorum, pre_vote, lease_read,
    election_tick 64), a 192-round settle, k=8."""
    with open(ZIPF_MIXED, encoding="utf-8") as f:
        doc = json.load(f)
    got, tr, _ = _split_pair(doc, 16, 192, election_tick=64, check_quorum=True,
                             pre_vote=True, lease_read=True)
    assert 0 < got[9] < 256 * 16


@pytest.mark.parametrize("case", ["check_quorum", "undamped"])
def test_split_runner_matches_unsplit(case):
    doc, settle, kw = {"check_quorum": (CQ_PLAN, 48, CQ_KW),
                       "undamped": (UNDAMPED_PLAN, 30, {})}[case]
    G = 12
    _, cfg, _, st = _settled_pair(G, 3, settle, **kw)
    compiled = twl.compile_plan(twl.plan_from_dict(doc), G, "cpu")

    def fresh():
        return (st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st),
                twl.init_read_carry(G, "cpu"))

    unsplit = twl.make_runner(cfg, compiled)(*fresh())
    split = twl.make_split_runner(cfg, compiled, k=K)(*fresh())
    as_numpy = tuple(
        tsim.SimState(*(None if v is None else v.numpy() for v in x)) if i == 0 else (
            tsim.HealthState(x.planes.numpy(), x.window_pos) if i == 1 else (
                type(x)(*(v.numpy() for v in x)) if i in (2, 6) else x.numpy()))
        for i, x in enumerate(unsplit))
    assert_workload_equal(as_numpy, split, f"{case}: split vs unsplit")
    assert 0 < split[9] < compiled.n_rounds * G


def test_split_runner_guards():
    G = 8
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True, **CQ_KW)
    compiled = twl.compile_plan(twl.plan_from_dict(CQ_PLAN), G, "cpu")
    empty = trc.compile_plan(trc.plan_from_dict(
        {"peers": 3, "phases": [{"rounds": 48, "op": {"add_learner": 3}}],
         "voters": [1, 2]}), G, "cpu")
    with pytest.raises(ValueError, match="bare client plans"):
        twl.make_split_runner(cfg, compiled, reconfig_compiled=empty)
    with pytest.raises(ValueError, match="collect_health"):
        twl.make_split_runner(cfg._replace(collect_health=False), compiled)
    with pytest.raises(ValueError, match="black box"):
        twl.make_split_runner(cfg._replace(blackbox=True), compiled)
    with pytest.raises(ValueError, match="health_window"):
        twl.make_split_runner(cfg, compiled, k=cfg.health_window + 8)
    with pytest.raises(ValueError, match="peers"):
        twl.make_split_runner(cfg._replace(n_peers=5), compiled)


# --- ClusterSim.run_reads ------------------------------------------------------


class Trace:
    """A metrics stand-in recording trace events."""

    def __init__(self):
        self.events = []

    def on_health_summary(self, summary):
        pass

    def trace(self, event, **fields):
        self.events.append((event, fields))


def test_run_reads_split_reports_match_jax_and_unsplit():
    """ClusterSim.run_reads(split=True) from a settled state against the
    JAX package's, and against split=False; the monitor gets the report."""
    G, P = 8, 3
    jcfg, tcfg, jst, tst = _settled_pair(G, P, 48, **CQ_KW)
    jplan, tplan = jwl.plan_from_dict(CQ_PLAN), twl.plan_from_dict(CQ_PLAN)
    jsm = jsim.ClusterSim(jcfg, health_monitor=JMonitor())
    jsm.state = jst
    mon = HealthMonitor(metrics=Trace())
    tsm = tsim.ClusterSim(tcfg, health_monitor=mon, device="cpu")
    tsm.state = tst
    want, got = jsm.run_reads(jplan, split=True), tsm.run_reads(tplan, split=True)
    assert got == want
    assert got["total_rounds"] == 48 * G and got["fused_rounds"] == 4 * K * G
    assert not any(got["safety"].values())
    assert_states_equal(jsm.state, tsm.state, "run_reads split")
    np.testing.assert_array_equal(tsm._health.planes.numpy(), np.asarray(jsm._health.planes))
    for f in twl.ReadCarry._fields:
        np.testing.assert_array_equal(getattr(tsm._read_carry, f).numpy(),
                                      np.asarray(getattr(jsm._read_carry, f)))
    assert mon.last()["reads"] == got
    assert [e for e, _ in mon.metrics.events] == ["reads.scenario"]
    unsplit = tsim.ClusterSim(tcfg, device="cpu")
    unsplit.state = tst
    base = unsplit.run_reads(tplan)
    assert base == {k: v for k, v in got.items()
                    if k not in ("fused_rounds", "total_rounds", "fused_frac")}
    assert_states_equal(jsm.state, unsplit.state, "run_reads unsplit")
    # The cached runner: the same plan object reruns without recompiling.
    runner = unsplit._read_runner[4]
    unsplit.state = tst
    unsplit.reset_health()
    assert unsplit.run_reads(tplan) == base and unsplit._read_runner[4] is runner
