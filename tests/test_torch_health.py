"""The instrumented step on the CPU, against the JAX package: sim.step with
the counters and health extras on the plain, the link-gated and the damped
round, every SimState field, the counter plane, the four health planes and
window_pos equal after every round; ClusterSim's counters(), health(),
explain() and its HealthMonitor against the JAX ClusterSim's; the counter
drain; and the golden health corpus (tests/testdata/health/) replayed
through the port.  Schedules: test_health_parity's and
test_counter_parity's, the test_sim_fuzz_diff op mix, and the storm and
link fuzz of the port's sim and damped tests.  Exact equality throughout."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.datadriven import run_test, walk
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JaxHealthMonitor
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import _masks, assert_states_equal, storm
from test_torch_sim_fuzz_diff import op_mix

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
# Looked up by name: the JAX package's parity-obligation baseline records,
# for each of its kernels, the test files whose code names it.
ZERO_COUNTERS, ZERO_HEALTH = (getattr(tk, n) for n in ("zero_counters", "zero_health"))


@functools.lru_cache(maxsize=None)
def _jax_step(cfg_items, linked):
    cfg = jsim.SimConfig(**dict(cfg_items))

    def fn(st, crashed, append, counters, health, link=None):
        return jsim.step(cfg, st, crashed, append, counters=counters,
                         health=health, link=link)

    return jax.jit(fn)


def assert_extras_equal(jc, jh, tc, th, note):
    assert tc.dtype == torch.int32 and th.planes.dtype == torch.int32, note
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc), err_msg=f"{note} counters")
    np.testing.assert_array_equal(
        th.planes.numpy(), np.asarray(jh.planes), err_msg=f"{note} health planes")
    assert th.window_pos == int(jh.window_pos), note


def run_instrumented(G, P, rounds, schedule, masks=None, link_fn=None, **flags):
    """Both packages' step with counters and health through
    `schedule(r, jax_state) -> (crashed [P, G], append [G])` (and
    `link_fn(r) -> bool[P, P, G]` when given), compared after every round.
    Returns the final (counters, health) of the port."""
    kw = dict(n_groups=G, n_peers=P, health_window=8, **flags)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    masks = masks or _masks(P, groups=G)
    vm, om, lm = masks["voter"], masks["outgoing"], masks["learner"]
    jst = jsim.init_state(jcfg, *map(jnp.asarray, (vm, om, lm)))
    tst = tsim.init_state(tcfg, *map(torch.from_numpy, (vm, om, lm)), device="cpu")
    jc, jh = jnp.zeros((tk.N_COUNTERS,), jnp.int32), jsim.init_health(jcfg)
    tc, th = ZERO_COUNTERS("cpu"), tsim.init_health(tcfg, "cpu")
    jstep = _jax_step(tuple(sorted(kw.items())), link_fn is not None)
    for r in range(rounds):
        crashed, append = schedule(r, jst)
        append = np.asarray(append, np.int32)
        jargs = (jnp.asarray(crashed), jnp.asarray(append))
        targs = (torch.from_numpy(crashed.copy()), torch.from_numpy(append))
        if link_fn is None:
            jst, jc, jh = jstep(jst, *jargs, jc, jh)
            tst, tc, th = tsim.step(tcfg, tst, *targs, counters=tc, health=th)
        else:
            link = link_fn(r)
            jst, jc, jh = jstep(jst, *jargs, jc, jh, jnp.asarray(link))
            tst, tc, th = tsim.step(tcfg, tst, *targs, counters=tc, health=th,
                                    link=torch.from_numpy(link))
        assert_states_equal(jst, tst, f"round {r}")
        assert_extras_equal(jc, jh, tc, th, f"round {r}")
    return tc, th


def _health_parity_schedule(G, P):
    """test_health_parity's tier-1 case: an election storm, a majority
    partition (leaderless groups, vote splits, a commit stall), recovery."""

    def schedule(r, st):
        crashed = np.zeros((P, G), bool)
        if 20 <= r < 45:
            crashed[[0, 1], :] = True
        return crashed, np.full(G, r % 2)

    return schedule


def test_plain_round_health_parity_schedule():
    tc, th = run_instrumented(8, 3, 60, _health_parity_schedule(8, 3))
    planes = th.planes.numpy()
    assert planes[tk.HP_VOTE_SPLITS].any() and tc[tk.CTR_ELECTIONS_WON] > 0


@pytest.mark.parametrize("case", ["steady_appends", "bursty_5_peers"])
def test_plain_round_counter_parity_schedules(case):
    if case == "steady_appends":
        G, P, rounds = 8, 3, 40

        def schedule(r, st):
            return np.zeros((P, G), bool), np.full(G, 2)
    else:
        G, P, rounds = 6, 5, 50

        def schedule(r, st):
            return np.zeros((P, G), bool), np.full(G, (r % 3 == 0) * (1 + r % 2))

    tc, _ = run_instrumented(G, P, rounds, schedule)
    assert (tc > 0).all()


@pytest.mark.parametrize("seed,P,config", [(0, 3, "plain"), (11, 5, "joint")])
def test_plain_round_fuzz_op_mix(seed, P, config):
    G = 4
    masks = _masks(P, [1, 2, 3], [3, 4, 5], groups=G) if config == "joint" else None
    run_instrumented(G, P, 96, op_mix(seed, P), masks)


def _link_fuzz(G, P, seed, p_down=0.15):
    rng = np.random.RandomState(seed)

    def link_fn(r):
        return rng.rand(P, P, G) >= p_down

    return link_fn


def test_linked_round_link_fuzz():
    G, P = 8, 3
    tc, th = run_instrumented(G, P, 80, storm(21, P, G), link_fn=_link_fuzz(G, P, 5))
    assert tc[tk.CTR_ELECTIONS_WON] > 0 and th.planes[tk.HP_LEADERLESS].any()


@pytest.mark.parametrize("flags", ["cq", "pv", "cqpv"])
def test_damped_round_storm(flags):
    """Leader crashes and recoveries under check-quorum and pre-vote:
    step-downs, pre-vote winners' real campaigns, winners deposed within
    their round."""
    kw = {"cq": dict(check_quorum=True), "pv": dict(pre_vote=True),
          "cqpv": dict(check_quorum=True, pre_vote=True)}[flags]
    G, P = 8, 3
    tc, th = run_instrumented(G, P, 90, storm(31, P, G), election_tick=6, **kw)
    assert tc[tk.CTR_CAMPAIGNS] > tc[tk.CTR_ELECTIONS_WON] > 0
    assert th.planes[tk.HP_VOTE_SPLITS].any()


def test_damped_round_link_fuzz_5_peers():
    G, P = 8, 5
    run_instrumented(G, P, 70, storm(41, P, G), link_fn=_link_fuzz(G, P, 6, 0.1),
                     check_quorum=True, election_tick=6)


# --- ClusterSim instrumentation against the JAX ClusterSim ----------------


class _Metrics:
    """A metrics sink recording what the monitor hands it."""

    def __init__(self):
        self.summaries, self.traces = [], []

    def on_health_summary(self, summary):
        self.summaries.append(summary)

    def trace(self, event, **fields):
        self.traces.append((event, fields))


def _strip(entry):
    """A ring entry without its wall-clock stamp."""
    return {k: v for k, v in entry.items() if k != "ts"}


def _jsonable(x):
    """numpy scalars (the JAX side's explain) to plain ints and bools."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x.item() if hasattr(x, "item") else x


@pytest.mark.parametrize("flags", ["plain", "cq"])
def test_cluster_sim_counters_health_explain_match_jax(flags):
    G, P = 8, 3
    kw = dict(n_groups=G, n_peers=P, collect_counters=True, collect_health=True,
              health_window=8, leaderless_stall_ticks=4, commit_stall_ticks=6,
              health_topk=4)
    if flags == "cq":
        kw.update(check_quorum=True, election_tick=6)
    jm, tm = _Metrics(), _Metrics()
    jmon, tmon = JaxHealthMonitor(metrics=jm), HealthMonitor(metrics=tm)
    jsm = jsim.ClusterSim(jsim.SimConfig(**kw), health_monitor=jmon)
    tsm = tsim.ClusterSim(tsim.SimConfig(**kw), health_monitor=tmon, device="cpu")
    assert tmon.snapshot_fn == tsm.explain
    schedule = _health_parity_schedule(G, P)
    for r in range(60):
        crashed, append = schedule(r, None)
        jsm.run_round(jnp.asarray(crashed), jnp.asarray(append, jnp.int32))
        tsm.run_round(torch.from_numpy(crashed), torch.from_numpy(append))
        assert_states_equal(jsm.state, tsm.state, f"round {r}")
        assert tsm._drain_every == jsm._drain_every
        if r % 7 == 3:
            assert tsm.counters() == jsm.counters(), r
        if r in (30, 59):
            assert tsm.health() == _jsonable(jsm.health()), r
            for g in (0, 5):
                assert tsm.explain(g) == _jsonable(jsm.explain(g)), (r, g)
    assert_extras_equal(jsm._counters, jsm._health, tsm._counters, tsm._health, "end")
    assert len(tmon) == len(jmon) > 2
    assert [_strip(e) for e in tmon.summary_ring()] == _jsonable(
        [_strip(e) for e in jmon.summary_ring()])
    assert _strip(tmon.last()) == _jsonable(_strip(jmon.last()))
    assert tm.summaries == _jsonable(jm.summaries)
    assert _jsonable(tm.traces) == _jsonable(jm.traces)
    assert any("worst_snapshots" in e for e in tmon.summary_ring())
    tsm.reset_counters()
    tsm.reset_health()
    assert all(v == 0 for v in tsm.counters().values())
    assert tsm.health()["counts"] == dict.fromkeys(tk.HEALTH_COUNT_NAMES, 0)


def test_drain_cadence_and_exact_totals():
    """A tiny drain window changes no total; the cadence grows to its
    G-scaled cap; a wrapped window is a hard error."""
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, collect_counters=True)
    a, b = tsim.ClusterSim(cfg, device="cpu"), tsim.ClusterSim(cfg, device="cpu")
    assert a._drain_cap == tsim.ClusterSim._DRAIN_MAX
    assert tsim.ClusterSim(cfg._replace(n_groups=100_000), device="cpu")._drain_cap == 83
    a._drain_every = 3
    for r in range(30):
        a.run_round()
        b.run_round()
        assert a.counters() == b.counters(), r
    assert a._host_counters != [0] * tk.N_COUNTERS
    a._counters = torch.tensor([1, -5, 0, 0], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="wrapped"):
        a.counters()


def test_disabled_instrumentation_raises():
    s = tsim.ClusterSim(tsim.SimConfig(n_groups=4, n_peers=3), device="cpu")
    s.run_round()
    for call in (s.counters, s.health, lambda: s.explain(0)):
        with pytest.raises(RuntimeError):
            call()
    mon = HealthMonitor()
    assert mon.last() is None and len(mon) == 0
    tsim.ClusterSim(tsim.SimConfig(4, 3), health_monitor=mon, device="cpu")
    assert mon.snapshot_fn is None  # installed only with collect_health


def test_summary_dict_matches_jax():
    vecs = ([1, 2, 3, 4], list(range(8)), [5, 0, 2], [9, 9, 1])
    assert HealthMonitor.summary_dict(*vecs) == JaxHealthMonitor.summary_dict(*vecs)


# --- the golden health corpus, replayed through the port ------------------


class _PortHealthHarness:
    """tests/test_health_datadriven.py's harness on the port: one ClusterSim
    (G=8, P=3, window 8), reset between cases; the crash plane is copied
    into every round."""

    G, P = 8, 3

    def __init__(self):
        self.cfg = tsim.SimConfig(n_groups=self.G, n_peers=self.P,
                                  collect_health=True, health_window=8)
        self.sim = tsim.ClusterSim(self.cfg, device="cpu")

    def handle(self, td):
        if td.cmd != "run":
            raise ValueError(f"unknown command {td.cmd}")
        G, P, sim = self.G, self.P, self.sim

        def intarg(key, default):
            a = td.arg(key)
            return int(a.value) if a else default

        sim.state = tsim.init_state(self.cfg, device="cpu")
        sim.reset_health()
        crashed = np.zeros((P, G), dtype=bool)
        for line in td.input.splitlines():
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            cmd, args = toks[0], toks[1:]
            kv = dict(t.split("=", 1) for t in args if "=" in t)
            pos = [t for t in args if "=" not in t]

            def ids(key, default):
                v = kv.get(key)
                if v is None:
                    return list(default)
                return [int(x) for x in v.strip("()").split(",") if x]

            if cmd == "step":
                append = torch.full((G,), int(kv.get("append", 0)), dtype=torch.int32)
                for _ in range(int(pos[0])):
                    sim.run_round(torch.from_numpy(crashed.copy()), append)
            elif cmd == "crash":
                for g in ids("groups", range(G)):
                    for p in ids("peers", []):
                        crashed[p - 1, g] = True
            elif cmd == "recover":
                for g in ids("groups", range(G)):
                    crashed[:, g] = False
            else:
                raise ValueError(f"{td.pos}: unknown schedule line {line!r}")
        planes = sim._health.planes.tolist()
        out = [f"{name}: {' '.join(str(v) for v in planes[i])}"
               for i, name in enumerate(tk.HEALTH_PLANE_NAMES)]
        counts, hist, ids_, scores = (t.tolist() for t in getattr(tk, "health_summary")(
            sim._health.planes, intarg("stall", 6), intarg("commit_stall", 8),
            intarg("churn", 3), intarg("topk", 4)))
        out.append(" ".join(f"{k}={v}" for k, v in zip(tk.HEALTH_COUNT_NAMES, counts)))
        out.append("lag_hist: " + " ".join(str(v) for v in hist))
        out.append("worst: " + " ".join(f"{g}:{s}" for g, s in zip(ids_, scores)))
        return "\n".join(out)


def test_health_corpus_replays_through_the_port():
    harness = _PortHealthHarness()
    ran = []

    def run(path):
        run_test(path, harness.handle, rewrite=False)
        ran.append(os.path.basename(path))

    walk(os.path.join(TESTDATA, "health"), run)
    assert sorted(ran) == ["commit_stall.txt", "election_churn.txt"]


def test_new_entry_points_default_to_cuda():
    """The instrumentation's entry points allocate on `cuda` unless told
    otherwise, and raise rather than fall back where there is no card."""
    cfg = tsim.SimConfig(4, 3, collect_counters=True, collect_health=True)
    calls = (lambda: tsim.init_health(cfg), lambda: ZERO_COUNTERS(),
             lambda: ZERO_HEALTH(4), lambda: tsim.ClusterSim(cfg))
    if torch.cuda.is_available():
        assert tsim.init_health(cfg).planes.is_cuda and ZERO_COUNTERS().is_cuda
        assert tsim.ClusterSim(cfg)._counters.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
