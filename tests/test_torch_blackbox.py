"""The port's device black box against the JAX package on the CPU, exactly
(every plane is int32 or bool; the ring word is the reference's uint32
bits in an int32 tensor):

  * the ring word's pack and unpack, round-tripped through np.uint32;
  * the fold, the mark (on a fresh recorder too) and the capture (ties go
    to the lower group id) on random planes;
  * check_safety_groups over tests/test_forensics.py's random-argument
    matrix, its row sums equal to check_safety;
  * `sim.step(blackbox=)` on the plain round (with the counters and health
    extras), the link-gated round and the damped round (with a read
    probe), round by round: the state, the extras' order and the ring;
  * `steady_mask` on a black-box config (all False) and the dispatcher's
    general branch;
  * ClusterSim's black box: run_round, record_safety, the drain's
    incident reports, forensics() and incident_report();
  * HealthMonitor.record_incident and incidents(), and the new entry
    points' default device.

Kernel functions are looked up by name (getattr), so the JAX package's
parity-obligation baseline stays as it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import ClusterSim as JClusterSim
from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import forensics as tfx
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import assert_states_equal

N_SAFETY = 9


def kfn(mod, name):
    """A kernel function looked up by name (see the module docstring)."""
    return getattr(mod, name)


def t(a, dtype=None):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.from_numpy(a.copy())
    return out if dtype is None else out.to(dtype)


def assert_bb_equal(jbb, tbb, note=""):
    """Every BlackboxState field equal, meta compared as uint32 words."""
    got = tsim.blackbox_to_numpy(tbb)
    assert got["meta"].dtype == np.uint32, note
    for f in jsim.BlackboxState._fields:
        w = np.asarray(getattr(jbb, f))
        if f == "round_idx":
            assert got[f] == int(w), f"{note}: round_idx"
            continue
        assert getattr(tbb, f).dtype == torch.int32, f"{note}: {f}"
        np.testing.assert_array_equal(got[f], w, err_msg=f"{note}: {f}")


# --- the kernels -------------------------------------------------------------


def test_meta_round_trip_through_uint32():
    rng = np.random.RandomState(3)
    role = rng.randint(0, 4, size=(6, 9)).astype(np.int32)
    lead = rng.randint(0, 16, size=(6, 9)).astype(np.int32)
    # Full 32-bit words: the shift must drop the bits past 32 as uint32 does.
    bits = rng.randint(0, 2**32, size=(6, 9), dtype=np.uint64).astype(np.uint32)
    bits[0] = rng.randint(0, 1 << N_SAFETY, size=9)
    want = np.asarray(kfn(jk, "pack_blackbox_meta")(
        jnp.asarray(role), jnp.asarray(lead), jnp.asarray(bits)))
    got = kfn(tk, "pack_blackbox_meta")(t(role), t(lead), t(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    jparts = kfn(jk, "unpack_blackbox_meta")(jnp.asarray(want))
    tparts = kfn(tk, "unpack_blackbox_meta")(got)
    for w, g in zip(jparts, tparts):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    np.testing.assert_array_equal(tparts[0][0].numpy(), role[0])
    np.testing.assert_array_equal(tparts[1][0].numpy(), lead[0])
    np.testing.assert_array_equal(tparts[2][0].numpy(), bits[0].astype(np.int64))


def test_fold_mark_and_capture_match_jax():
    rng = np.random.RandomState(11)
    W, G, P = 4, 12, 3
    jbb = kfn(jk, "zero_blackbox")(G, W)
    tbb = kfn(tk, "zero_blackbox")(G, W, "cpu")
    assert tbb[4] == 0
    # A mark on a fresh recorder changes nothing.
    viol = rng.rand(N_SAFETY, G) < 0.5
    jm = kfn(jk, "blackbox_mark")(jbb[0], jbb[3], jbb[4], jnp.asarray(viol))
    tm = kfn(tk, "blackbox_mark")(tbb[0], tbb[3], tbb[4], t(viol))
    for w, g in zip(jm, tm):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32))
    assert (tm[1] == tk.INF).all()
    for r in range(2 * W + 1):
        state = rng.randint(0, 4, size=(P, G)).astype(np.int32)
        term = rng.randint(0, 9, size=(P, G)).astype(np.int32)
        commit = rng.randint(0, 30, size=(P, G)).astype(np.int32)
        crashed = rng.rand(P, G) < 0.3
        viol = rng.rand(N_SAFETY, G) < 0.08
        jbb = kfn(jk, "blackbox_fold")(*jbb, jnp.asarray(state), jnp.asarray(term),
                                       jnp.asarray(commit), jnp.asarray(crashed),
                                       jnp.asarray(viol))
        tbb = kfn(tk, "blackbox_fold")(*tbb, t(state), t(term), t(commit), t(crashed),
                                       t(viol))
        assert_bb_equal(jsim.BlackboxState(*jbb), tsim.BlackboxState(*tbb), f"fold {r}")
        if r % 3 == 2:
            mark = rng.rand(N_SAFETY, G) < 0.1
            jm = kfn(jk, "blackbox_mark")(jbb[0], jbb[3], jbb[4], jnp.asarray(mark))
            tm = kfn(tk, "blackbox_mark")(tbb[0], tbb[3], tbb[4], t(mark))
            jbb = (jm[0], jbb[1], jbb[2], jm[1], jbb[4])
            tbb = (tm[0], tbb[1], tbb[2], tm[1], tbb[4])
            assert_bb_equal(jsim.BlackboxState(*jbb), tsim.BlackboxState(*tbb),
                            f"mark {r}")
    # The capture, with ties on the trip round across group ids.
    trip = np.full((N_SAFETY, G), jk.INF, np.int32)
    trip[0, [7, 2, 9]] = 5
    trip[0, 4] = 3
    trip[1, :] = rng.randint(0, 4, size=G)
    trip[2, 11] = 0
    for plane in (trip, np.asarray(jbb[3])):  # hand-made ties, then the folds'
        for k in (1, 3, G):
            want = kfn(jk, "blackbox_capture")(jnp.asarray(plane), k)
            got = kfn(tk, "blackbox_capture")(t(plane), k)
            for name, w, g in zip(("counts", "ids", "rounds"), want, got):
                assert g.dtype == torch.int32, name
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"k={k} {name}")
    got = kfn(tk, "blackbox_capture")(t(trip), 3)
    assert got[1][0].tolist()[:3] == [4, 2, 7]


def _random_safety_args(rng, G, P, with_masks, with_lease):
    """tests/test_forensics.py's random-argument matrix, as numpy."""
    state = rng.randint(0, 3, size=(P, G)).astype(np.int32)
    term = rng.randint(1, 5, size=(P, G)).astype(np.int32)
    commit = rng.randint(0, 20, size=(P, G)).astype(np.int32)
    last = commit + rng.randint(0, 4, size=(P, G)).astype(np.int32)
    agree = rng.randint(0, 22, size=(P, P, G)).astype(np.int32)
    prev = commit + rng.randint(-2, 2, size=(P, G)).astype(np.int32)
    kw = {}
    if with_masks:
        kw["voter_mask"] = rng.rand(P, G) < 0.8
        kw["outgoing_mask"] = rng.rand(P, G) < 0.2
        kw["matched"] = rng.randint(0, 22, size=(P, P, G)).astype(np.int32)
        kw["crashed"] = rng.rand(P, G) < 0.2
        kw["prev_voter_mask"] = rng.rand(P, G) < 0.8
        kw["prev_outgoing_mask"] = rng.rand(P, G) < 0.2
    if with_lease:
        kw["lease_holder"] = rng.rand(P, G) < 0.4
        kw["lease_fire"] = rng.rand(G) < 0.5
    return (state, term, commit, last, agree, prev), kw


@pytest.mark.parametrize("with_masks,with_lease", [
    (False, False), (True, False), (True, True), (False, True),
])
def test_check_safety_groups_matches_jax_and_counts(with_masks, with_lease):
    rng = np.random.RandomState(42)
    fired = 0
    for _ in range(10):
        args, kw = _random_safety_args(rng, 6, 3, with_masks, with_lease)
        want = np.asarray(kfn(jk, "check_safety_groups")(
            *map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in kw.items()}))
        targs, tkw = [t(a) for a in args], {k: t(v) for k, v in kw.items()}
        got = kfn(tk, "check_safety_groups")(*targs, **tkw)
        assert got.dtype == torch.bool and got.shape == (N_SAFETY, 6)
        np.testing.assert_array_equal(got.numpy(), want)
        counts = kfn(tk, "check_safety")(*targs, **tkw)
        assert torch.equal(got.sum(1, dtype=torch.int32), counts)
        fired += int(got.sum())
    assert fired > 0


# --- the step ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "linked", "damped"])
def test_step_blackbox_matches_jax(kind):
    """The round's record folds on the round-exit state, its extras in the
    reference's order: (state, counters, health, blackbox) on the plain
    round, (state, blackbox, receipt) on the damped one."""
    G, P, W = 8, 3, 4
    damped = kind == "damped"
    kw = dict(n_groups=G, n_peers=P, blackbox=True, blackbox_window=W,
              collect_counters=kind == "plain", collect_health=kind == "plain",
              check_quorum=damped, lease_read=damped)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    rng = np.random.RandomState({"plain": 1, "linked": 2, "damped": 3}[kind])

    def jround(st, bb, crashed, append, link, extras):
        if kind == "plain":
            return jsim.step(jcfg, st, crashed, append, counters=extras[0],
                             health=extras[1], blackbox=bb)
        if kind == "linked":
            return jsim.step(jcfg, st, crashed, append, link=link, blackbox=bb)
        return jsim.step(jcfg, st, crashed, append, link=link, blackbox=bb,
                         read_propose=jnp.full((G,), 2, jnp.int32))

    jstep = jax.jit(jround)
    jst, tst = jsim.init_state(jcfg), tsim.init_state(tcfg, device="cpu")
    jbb, tbb = jsim.init_blackbox(jcfg), tsim.init_blackbox(tcfg, "cpu")
    jex = (kfn(jk, "zero_counters")(), jsim.init_health(jcfg))
    tex = (kfn(tk, "zero_counters")("cpu"), tsim.init_health(tcfg, "cpu"))
    for r in range(40):
        crashed = rng.rand(P, G) < (0.15 if r > 20 else 0.0)
        append = rng.randint(0, 3, size=G).astype(np.int32)
        link = rng.rand(P, P, G) > (0.2 if kind != "plain" and r > 15 else 0.0)
        jout = jstep(jst, jbb, jnp.asarray(crashed), jnp.asarray(append),
                     jnp.asarray(link), jex)
        targs = (tcfg, tst, t(crashed), t(append))
        if kind == "plain":
            tout = tsim.step(*targs, counters=tex[0], health=tex[1], blackbox=tbb)
            jex, tex = jout[1:3], tout[1:3]
            assert torch.equal(tex[0], t(jex[0]))
            assert torch.equal(tex[1].planes, t(jex[1].planes))
            jbb, tbb = jout[3], tout[3]
        elif kind == "linked":
            tout = tsim.step(*targs, link=t(link), blackbox=tbb)
            jbb, tbb = jout[1], tout[1]
        else:
            tout = tsim.step(*targs, link=t(link), blackbox=tbb,
                             read_propose=torch.full((G,), 2, dtype=torch.int32))
            jbb, tbb = jout[1], tout[1]
            assert isinstance(tout[2], tsim.ReadReceipt)
            np.testing.assert_array_equal(tout[2].index.numpy(), np.asarray(jout[2].index))
        assert isinstance(tbb, tsim.BlackboxState)
        jst, tst = jout[0], tout[0]
        assert_states_equal(jst, tst, f"{kind} round {r}")
        assert_bb_equal(jbb, tbb, f"{kind} round {r}")
    assert tbb.round_idx == 40 and (tbb.trip_round == tk.INF).all()
    back = tsim.blackbox_from_numpy(tsim.blackbox_to_numpy(tbb), "cpu")
    assert_bb_equal(jbb, back, "numpy round trip")


def test_steady_mask_defuses_a_blackbox_config():
    """A black-box config rejects every fused horizon, as the reference's
    steady_mask does, so the dispatcher runs the general rounds and equals
    k plain steps; the same state is steady with the black box off."""
    G, P = 8, 3
    cfg = tsim.SimConfig(n_groups=G, n_peers=P)
    sim = tsim.ClusterSim(cfg, device="cpu")
    sim.run(25, None, torch.ones(G, dtype=torch.int32))
    crashed = torch.zeros((P, G), dtype=torch.bool)
    assert tfs.steady_mask(cfg, sim.state, crashed, horizon=4).all()
    bcfg = cfg._replace(blackbox=True)
    assert not tfs.steady_mask(bcfg, sim.state, crashed, horizon=4).any()
    jcfg = jsim.SimConfig(n_groups=G, n_peers=P, blackbox=True)
    jst = jsim.SimState(**{f: None if v is None else jnp.asarray(v.numpy())
                           for f, v in zip(tsim.SimState._fields, sim.state)})
    assert not np.asarray(jps.steady_mask(jcfg, jst, jnp.zeros((P, G), bool), horizon=4)).any()
    append = torch.ones(G, dtype=torch.int32)
    out, fused = tfs.fast_multi_round(bcfg, k=4, count_fused=True)(
        sim.state, crashed, append, 0)
    assert fused == 0
    want = sim.state
    for _ in range(4):
        want = tsim.step(cfg, want, crashed, append)
    assert all(torch.equal(a, b) for a, b in zip(want, out) if a is not None)


# --- ClusterSim and the monitor ------------------------------------------------


class Incidents:
    """A metrics stand-in with the reference Metrics' safety_incidents
    counter family and a trace recorder."""

    def __init__(self):
        self.counts = {}
        self.events = []

    @property
    def safety_incidents(self):
        outer = self

        class Family:
            def labels(self, slot):
                class Counter:
                    def inc(self, n):
                        outer.counts[slot] = outer.counts.get(slot, 0) + n
                return Counter()

        return Family()

    def on_health_summary(self, summary):
        pass

    def trace(self, event, **fields):
        self.events.append((event, fields))


def test_drain_reports_incidents_to_monitor():
    """tests/test_forensics.py's drain case on both packages: a mask stamped
    by record_safety on the last folded round reaches the monitor once per
    growth of its slot's count, the same incident and capture as JAX's."""
    G = 4
    kw = dict(n_groups=G, n_peers=3, blackbox=True)
    jmon, tmon = JMonitor(), HealthMonitor(metrics=Incidents())
    js = JClusterSim(jsim.SimConfig(**kw), health_monitor=jmon)
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), health_monitor=tmon, device="cpu")
    for _ in range(3):
        js.run_round(append_n=jnp.ones((G,), jnp.int32))
        ts.run_round(append_n=torch.ones(G, dtype=torch.int32))
    viol = np.zeros((N_SAFETY, G), bool)
    viol[jk.SV_DUAL_LEADER, 2] = True
    js.record_safety(jnp.asarray(viol))
    ts.record_safety(t(viol))
    assert_bb_equal(js._blackbox, ts._blackbox, "after record_safety")
    js._drain()
    ts._drain()
    assert tmon.incidents() == jmon.incidents()
    assert tmon.incidents() == [{"slot": "dual_leader", "count": 1,
                                 "offenders": [{"group": 2, "round": 2}]}]
    ts._drain()
    assert len(tmon.incidents()) == 1
    assert ts.forensics() == js.forensics()
    assert ts.incident_report() == js.incident_report()
    assert tmon.metrics.counts == {"dual_leader": 1}
    assert [e for e, _ in tmon.metrics.events] == ["forensics.incident"]
    ts.reset_forensics()
    assert ts._blackbox.round_idx == 0 and not any(ts.forensics()["counts"].values())
    with pytest.raises(RuntimeError, match="blackbox=True"):
        tsim.ClusterSim(tsim.SimConfig(n_groups=G, n_peers=3), device="cpu").forensics()


def test_cluster_sim_rounds_fold_as_jax():
    """run_round with the black box beside the counters and health planes
    (a monitor attached: the drain cadence runs) equals JAX's, ring and
    counters included, and the black box leaves the state as without it."""
    G = 6
    kw = dict(n_groups=G, n_peers=3, blackbox=True, blackbox_window=5,
              collect_counters=True, collect_health=True)
    js = JClusterSim(jsim.SimConfig(**kw), health_monitor=JMonitor())
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), health_monitor=HealthMonitor(),
                         device="cpu")
    plain = tsim.ClusterSim(tsim.SimConfig(n_groups=G, n_peers=3), device="cpu")
    rng = np.random.RandomState(5)
    for r in range(30):
        crashed = rng.rand(3, G) < (0.2 if r > 18 else 0.0)
        append = rng.randint(0, 3, size=G).astype(np.int32)
        js.run_round(jnp.asarray(crashed), jnp.asarray(append))
        ts.run_round(t(crashed), t(append))
        plain.run_round(t(crashed), t(append))
    assert_states_equal(js.state, ts.state, "end state")
    assert_states_equal(js.state, plain.state, "black box off")
    assert_bb_equal(js._blackbox, ts._blackbox, "ring")
    assert ts.counters() == js.counters()
    assert ts.forensics() == js.forensics()


def test_record_incident_matches_jax():
    inc = {"slot": "stale_read", "count": 2,
           "offenders": [{"group": 3, "round": 9}, {"group": 5, "round": 11}]}
    jmon, tmon = JMonitor(), HealthMonitor(metrics=Incidents())
    for mon in (jmon, tmon):
        entry = mon.record_incident(inc)
        assert entry["incident"] is inc and mon.incidents() == [inc]
        assert mon.summary_ring()[-1] is entry
        mon.record_incident({"slot": "stale_read", "count": 5, "offenders": []})
        mon.record_incident({"slot": "stale_read", "count": 4, "offenders": []})
    strip = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
             for e in jmon.summary_ring()]
    assert [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in tmon.summary_ring()] == strip
    # The counter grows by the new offenders only; every report is traced.
    assert tmon.metrics.counts == {"stale_read": 5}
    assert [e for e, _ in tmon.metrics.events] == ["forensics.incident"] * 3
    assert HealthMonitor().record_incident(inc)["incident"] is inc  # no metrics


def test_new_entry_points_default_to_cuda():
    """TrapSession, both traps, a black-box ClusterSim and init_blackbox
    allocate on `cuda` unless told otherwise, and raise rather than fall
    back where there is no card."""
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, blackbox=True)
    calls = (lambda: tfx.TrapSession(cfg).sim._blackbox.meta,
             lambda: tfx.run_commit_regress_trap(n_groups=4, settle_rounds=1).sim.state.term,
             lambda: tfx.run_clock_pause_trap(n_groups=2, settle_rounds=1,
                                              election_tick=2).sim.state.term,
             lambda: tsim.ClusterSim(cfg)._blackbox.trip_round,
             lambda: tsim.init_blackbox(cfg).term)
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError):
                call()
    assert tfx.TrapSession(cfg, device="cpu").sim._blackbox.meta.device.type == "cpu"
    with pytest.raises(ValueError, match="blackbox=True"):
        tfx.TrapSession(cfg._replace(blackbox=False), device="cpu")
