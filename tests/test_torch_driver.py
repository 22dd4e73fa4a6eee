"""The port's host driver (raft_tpu_torch/multiraft/driver.py: MultiRaft over
the scalar RawNode, on the CPU) against raft_tpu's.

* The three cases of tests/test_multiraft_driver.py on the port, each beside
  the reference's outcome.
* A lockstep run: 3 drivers x 16 groups a package, 120 ticks, health on
  (window 8), one shared Metrics a package; proposals and leader transfers
  at seeded ticks, 10 % of messages dropped, driver 2 paused for 20 ticks.  After every tick the
  active masks, the eight mirrors, every group's (term, vote, state,
  leader_id, committed, last_index), each Ready and LightReady as codec
  bytes, health(), mttr(), status(), autopilot_report() and
  metrics_snapshot() are equal; of the tick-sync histogram only the
  observation count is compared (its sum and buckets are wall times).
* The driver cases of test_health_monitor.py, test_metrics.py,
  test_harness_errors.py, test_autopilot.py and test_forensics.py on the
  port, each beside the reference's result.

Every comparison is exact."""

import types

import numpy as np
import pytest

import raft_tpu
from raft_tpu import codec as rcodec
from raft_tpu import eraftpb as reraftpb
from raft_tpu.config import HealthConfig as RHealthConfig
from raft_tpu.metrics import EventTracer as REventTracer
from raft_tpu.metrics import Metrics as RMetrics
from raft_tpu.multiraft.driver import MultiRaft as RMultiRaft
import raft_tpu_torch as T
from raft_tpu_torch.multiraft import driver as tdriver
from raft_tpu_torch.scalar import codec as tcodec
from raft_tpu_torch.scalar import eraftpb as teraftpb
from raft_tpu_torch.scalar.config import HealthConfig as THealthConfig

from test_torch_raw_node import light_record, ready_record

REF = types.SimpleNamespace(
    name="raft_tpu", Config=raft_tpu.Config, MemStorage=raft_tpu.MemStorage,
    ArrayStorage=raft_tpu.ArrayStorage, RawNode=raft_tpu.RawNode,
    StateRole=raft_tpu.StateRole, Message=raft_tpu.Message,
    MessageType=raft_tpu.MessageType, ConfState=raft_tpu.ConfState,
    NO_LIMIT=raft_tpu.NO_LIMIT, HealthConfig=RHealthConfig, Metrics=RMetrics,
    EventTracer=REventTracer, pb=reraftpb, codec=rcodec,
    MultiRaft=RMultiRaft)
PORT = types.SimpleNamespace(
    name="raft_tpu_torch", Config=T.Config, MemStorage=T.MemStorage,
    ArrayStorage=T.ArrayStorage, RawNode=T.RawNode, StateRole=T.StateRole,
    Message=T.Message, MessageType=T.MessageType, ConfState=T.ConfState,
    NO_LIMIT=T.NO_LIMIT, HealthConfig=THealthConfig, Metrics=T.Metrics,
    EventTracer=T.EventTracer, pb=teraftpb, codec=tcodec,
    MultiRaft=lambda *a, **kw: T.MultiRaft(*a, device="cpu", **kw))
PKGS = (REF, PORT)
PEERS = [1, 2, 3]
MIRRORS = ("_state", "_ee", "_hb", "_rt", "_promotable", "_leader", "_term",
           "_commit")
SYNC = "multiraft_tick_sync_seconds"


def base_config(pkg, id=1, heartbeat_tick=3, metrics=None):
    return pkg.Config(id=id, election_tick=10, heartbeat_tick=heartbeat_tick,
                      max_size_per_msg=pkg.NO_LIMIT, max_inflight_msgs=256,
                      metrics=metrics)


def make_cluster(pkg, G, metrics=None, health=None):
    """Three drivers (one per peer id), G groups each."""
    return {id: pkg.MultiRaft(base_config(pkg, id, metrics=metrics),
                              [pkg.MemStorage.new_with_conf_state((PEERS, []))
                               for _ in range(G)], health=health)
            for id in PEERS}


def persist(store, rd):
    with store.wl() as core:
        if not rd.snapshot.is_empty():
            core.apply_snapshot(rd.snapshot.clone())
        if rd.entries:
            core.append(rd.entries)
        if rd.hs is not None:
            core.set_hardstate(rd.hs.clone())


def pump(pkg, drivers, record=None, drop=None, paused=()):
    """Deliver all pending messages until quiescence through the Ready
    protocol (tests/test_multiraft_driver.py:pump); with `record`, append
    every Ready and LightReady to it; `drop` (an iterator of bools) drops a
    message where it yields True; a paused driver neither runs its Readys
    nor receives."""
    for _ in range(100):
        moved = False
        outbox = []
        for id, d in drivers.items():
            if id in paused:
                continue
            for g in d.ready_groups():
                rd = d.ready(g)
                if record is not None:
                    record.append((id, g, ready_record(pkg, rd)))
                msgs = rd.take_messages()
                persist(d.node(g).raft.raft_log.store, rd)
                msgs += rd.persisted_messages()
                light = d.advance(g, rd)
                if record is not None:
                    record.append((id, g, light_record(pkg, light)))
                msgs += light.take_messages()
                d.advance_apply(g)
                outbox += [(g, m) for m in msgs]
                moved = True
        deliveries = {}
        for g, m in outbox:
            if (drop is not None and next(drop)) or m.to in paused:
                continue
            deliveries.setdefault(m.to, []).append((g, m))
        for to, batch in deliveries.items():
            drivers[to].step_batch(batch)
            moved = True
        if not moved:
            return


# --- tests/test_multiraft_driver.py on the port --------------------------------


def elections_and_proposals(pkg):
    G = 8
    drivers = make_cluster(pkg, G)
    ticks = 0
    for ticks in range(1, 61):
        for d in drivers.values():
            d.tick()
        pump(pkg, drivers)
        if sum(d.status()["n_leaders"] for d in drivers.values()) == G:
            break
    assert sum(d.status()["n_leaders"] for d in drivers.values()) == G
    for g in range(G):
        for d in drivers.values():
            if d.node(g).raft.state == pkg.StateRole.Leader:
                d.propose(g, b"", b"payload")
                break
    pump(pkg, drivers)
    commits = [[d.node(g).raft.raft_log.committed for d in drivers.values()]
               for g in range(G)]
    assert all(min(c) >= 2 for c in commits), commits
    return ticks, commits


def device_tick_matches_scalar_tick(pkg):
    G = 6
    driver = pkg.MultiRaft(base_config(pkg), [
        pkg.MemStorage.new_with_conf_state((PEERS, [])) for _ in range(G)])
    plain = []
    for g in range(G):
        cfg = base_config(pkg)
        cfg.timeout_seed = g
        plain.append(pkg.RawNode(cfg, pkg.MemStorage.new_with_conf_state((PEERS, []))))
    out = []
    for t in range(40):
        driver.tick()
        for n in plain:
            n.tick()
        for g in range(G):
            a, b = driver.node(g).raft, plain[g].raft
            assert (a.term, a.state, len(a.msgs), a.randomized_election_timeout) == (
                b.term, b.state, len(b.msgs), b.randomized_election_timeout), f"t{t} g{g}"
            out.append((a.term, int(a.state), len(a.msgs),
                        a.randomized_election_timeout))
    return out


def tick_is_sparse(pkg):
    G = 32
    d = pkg.MultiRaft(base_config(pkg), [
        pkg.MemStorage.new_with_conf_state((PEERS, [])) for _ in range(G)])
    fired = sum(int(d.tick().sum()) for _ in range(9))  # min timeout is 10
    assert fired == 0
    return fired


@pytest.mark.parametrize("case", [elections_and_proposals,
                                  device_tick_matches_scalar_tick, tick_is_sparse],
                         ids=lambda f: f.__name__)
def test_multiraft_driver_cases(case):
    assert case(PORT) == case(REF)


# --- the lockstep run -----------------------------------------------------------


LOCK_G, LOCK_TICKS = 16, 120
PAUSED_ID, PAUSE = 2, range(40, 60)


def lockstep_plan(seed=11):
    """Per tick: the groups that propose, the (group, transferee) leader
    transfers, and the drop draws (10 %)."""
    rng = np.random.RandomState(seed)
    proposals = [np.nonzero(rng.rand(LOCK_G) < 0.15)[0].tolist() if rng.rand() < 0.4
                 else [] for _ in range(LOCK_TICKS)]
    # Transfers to the paused driver stall until the leader's election
    # timeout boundary aborts them.
    transfers = [[(int(rng.randint(LOCK_G)),
                   PAUSED_ID if t in PAUSE else int(rng.randint(1, 4)))]
                 if rng.rand() < 0.15 else [] for t in range(LOCK_TICKS)]
    drops = [rng.rand(4096) < 0.10 for _ in range(LOCK_TICKS)]
    return proposals, transfers, drops


def metrics_view(m):
    """The shared registry without the tick-sync wall times: the snapshot
    but its sum, and the exposition but the sum and bucket lines."""
    snap = m.registry.snapshot()
    assert snap[f"{SYNC}_count"] >= 0
    snap.pop(f"{SYNC}_sum")
    text = [line for line in m.registry.expose().splitlines()
            if not line.startswith((f"{SYNC}_sum", f"{SYNC}_bucket"))]
    return snap, text


class Lockstep:
    """One package's three drivers under the lockstep plan."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.metrics = pkg.Metrics()
        self.drivers = make_cluster(pkg, LOCK_G, self.metrics,
                                    pkg.HealthConfig(window=8))

    def leader(self, g, paused):
        for id, d in self.drivers.items():
            if id not in paused and d.node(g).raft.state == self.pkg.StateRole.Leader:
                return d
        return None

    def tick(self, t, proposals, transfers, drops):
        drivers = self.drivers
        paused = (PAUSED_ID,) if t in PAUSE else ()
        rec = {"active": {id: d.tick().tolist() for id, d in drivers.items()
                          if id not in paused}}
        for g in proposals:
            d = self.leader(g, paused)
            if d is not None:
                d.propose(g, b"", b"t%d" % t)
        for g, to in transfers:
            d = self.leader(g, paused)
            if d is not None:
                d.transfer_leader(g, to)
        rec["pending"] = {id: d.transfer_pending() for id, d in drivers.items()}
        readies = []
        pump(self.pkg, drivers, readies, iter(drops), paused)
        rec["readies"] = readies
        rec["mirrors"] = {id: [getattr(d, f).tolist() for f in MIRRORS]
                          for id, d in drivers.items()}
        rec["groups"] = {id: [(n.raft.term, n.raft.vote, int(n.raft.state),
                               n.raft.leader_id, n.raft.raft_log.committed,
                               n.raft.raft_log.last_index()) for n in d.nodes]
                         for id, d in drivers.items()}
        rec["health"] = {id: d.health() for id, d in drivers.items()}
        rec["mttr"] = {id: d.mttr() for id, d in drivers.items()}
        rec["autopilot"] = {id: d.autopilot_report() for id, d in drivers.items()}
        status = {}
        for id, d in drivers.items():
            st = d.status()
            st["metrics"].pop(f"{SYNC}_sum")
            status[id] = st
        rec["status"] = status
        snap = drivers[1].metrics_snapshot()
        assert snap == self.metrics.registry.snapshot()
        rec["metrics"] = metrics_view(self.metrics)
        return rec


def test_lockstep_drivers_equal_the_reference():
    proposals, transfers, drops = lockstep_plan()
    ref, port = Lockstep(REF), Lockstep(PORT)
    re_elected, pending = False, 0
    for t in range(LOCK_TICKS):
        want = ref.tick(t, proposals[t], transfers[t], drops[t])
        got = port.tick(t, proposals[t], transfers[t], drops[t])
        pending += sum(got["pending"].values())
        for key in want:
            assert got[key] == want[key], f"tick {t}: {key}"
        re_elected |= t > PAUSE.stop and any(
            m["reelections"] > LOCK_G for m in got["mttr"].values())
    snap = port.metrics.registry.snapshot()
    assert snap[f"{SYNC}_count"] == ref.metrics.registry.snapshot()[f"{SYNC}_count"]
    assert snap[f"{SYNC}_count"] == 3 * LOCK_TICKS - len(PAUSE)
    assert sum(g[4] for d in got["groups"].values() for g in d) > 3 * LOCK_G
    assert re_elected  # the pause forced re-elections
    assert pending > 10  # transfers stalled across ticks, until aborted


# --- the driver cases of the other reference tests -----------------------------


def singleton_driver(pkg, G=4, metrics=None, health=None, storage="MemStorage"):
    """G single-voter groups (tests/test_health_monitor.py:singleton_driver)."""
    cls = getattr(pkg, storage)
    return pkg.MultiRaft(base_config(pkg, metrics=metrics),
                         [cls.new_with_conf_state(([1], [])) for _ in range(G)],
                         health=health)


def pump_one(d):
    for g in d.ready_groups():
        rd = d.ready(g)
        persist(d.node(g).raft.raft_log.store, rd)
        d.advance(g, rd)
        d.advance_apply(g)


def health_planes_and_summary(pkg):
    m = pkg.Metrics()
    d = singleton_driver(pkg, G=4, metrics=m,
                         health=pkg.HealthConfig(window=8, leaderless_stall_ticks=4))
    for _ in range(6):
        d.tick()
    early = d.health()
    for _ in range(25):
        d.tick()
        pump_one(d)
    s = d.health()
    assert s["counts"]["leaderless"] == 0 and s["counts"]["stalled_leaderless"] == 0
    assert len(s["worst"]) == 4 and sum(s["lag_hist"]) == 4
    info = d.explain(0)
    assert info["leader_id"] == 1 and info["commit"] >= 1
    assert info["health"]["leaderless_ticks"] == 0
    assert len(d.health_monitor) >= 1
    snap = m.registry.snapshot()
    assert snap["health_groups_leaderless"] == 0
    snap.pop(f"{SYNC}_sum")
    return early, s, info, len(d.health_monitor), snap


def health_disabled_raises(pkg):
    d = singleton_driver(pkg, G=2)
    with pytest.raises(RuntimeError):
        d.health()
    with pytest.raises(RuntimeError):
        d.mttr()
    assert "health" not in d.explain(0)
    return d.explain(0)


def mttr_counts_reelection_episodes(pkg):
    d = singleton_driver(pkg, G=3, health=pkg.HealthConfig(window=8))
    m0 = d.mttr()
    assert m0["reelections"] == 0 and m0["mttr_ticks"] is None
    for _ in range(25):
        d.tick()
        pump_one(d)
    m1 = d.mttr()
    assert m1["reelections"] == 3 and m1["mttr_ticks"] >= 1
    assert m1["max_leaderless_streak"] >= 1
    assert m1["leaderless_group_ticks"] >= m1["reelections"]
    return m0, m1


def health_with_array_storage(pkg):
    d = singleton_driver(pkg, G=2, health=pkg.HealthConfig(), storage="ArrayStorage")
    for _ in range(25):
        d.tick()
        pump_one(d)
    s = d.health()
    assert s["counts"]["leaderless"] == 0 and d.explain(0)["commit"] >= 1
    return s, d.explain(0)


def ready_scan_skips_idle_groups(pkg):
    m = pkg.Metrics()
    d = singleton_driver(pkg, G=8, metrics=m)
    for _ in range(25):
        d.tick()
        pump_one(d)
    scanned, skipped = ("multiraft_ready_scan_groups_scanned_total",
                        "multiraft_ready_scan_groups_skipped_total")
    snap0 = m.registry.snapshot()
    assert d.ready_groups() == []
    snap1 = m.registry.snapshot()
    assert snap1[scanned] - snap0[scanned] == 0 and snap1[skipped] - snap0[skipped] == 8
    d.propose(3, b"", b"x")
    assert d.ready_groups() == [3]
    snap2 = m.registry.snapshot()
    assert snap2[scanned] - snap1[scanned] == 1
    return snap2[scanned], snap2[skipped]


def ready_scan_equivalent_to_full_scan(pkg):
    d = singleton_driver(pkg, G=6)
    rng = np.random.RandomState(3)
    out = []
    for r in range(40):
        d.tick()
        want = [g for g in range(d.G) if d.nodes[g].has_ready()]
        got = d.ready_groups()
        assert got == want, f"round {r}"
        out.append(got)
        if r % 3 == 0:
            g = int(rng.randint(d.G))
            if d.nodes[g].raft.leader_id:
                d.propose(g, b"", b"y")
        pump_one(d)
    return out


def driver_tick_and_sync_counters(pkg):
    """tests/test_metrics.py:197."""
    m = pkg.Metrics()
    G, n_ticks = 4, 25
    driver = pkg.MultiRaft(base_config(pkg, metrics=m), [
        pkg.MemStorage.new_with_conf_state(([1], [])) for _ in range(G)])
    for _ in range(n_ticks):
        driver.tick()
    snap = m.registry.snapshot()
    assert snap["multiraft_ticks_total"] == n_ticks
    assert snap[f"{SYNC}_count"] == n_ticks and snap[f"{SYNC}_sum"] > 0
    assert snap["multiraft_campaign_events_total"] >= G
    status = driver.status()
    assert status["metrics"]["multiraft_ticks_total"] == n_ticks
    assert driver.metrics_snapshot() == m.registry.snapshot()
    snap.pop(f"{SYNC}_sum")
    return snap


def injected_assertion_propagates_through_inbox(pkg):
    """tests/test_harness_errors.py:53."""
    store = pkg.MemStorage.new_with_conf_state(pkg.ConfState(voters=[1]))
    mr = pkg.MultiRaft(pkg.Config(id=1, election_tick=10, heartbeat_tick=1), [store])
    mr.campaign(0)

    def bad(m):
        raise AssertionError("injected bug inside step")

    mr.nodes[0].step = bad
    with pytest.raises(AssertionError, match="injected bug"):
        mr.step_batch([(0, pkg.Message(msg_type=pkg.MessageType.MsgBeat,
                                       from_=1, to=1))])
    return int(mr.node(0).raft.state)


def transfer_and_autopilot_report(pkg):
    """tests/test_autopilot.py:261."""
    mr = pkg.MultiRaft(base_config(pkg), [
        pkg.MemStorage.new_with_conf_state(([1], [])) for _ in range(2)],
        health=pkg.HealthConfig())
    mr.campaign(0)
    for _ in range(3):
        mr.tick()
    rep = mr.autopilot_report()
    assert rep["transfer_pending"] == 0 and "mttr" in rep
    assert mr.node(0).raft.state == pkg.StateRole.Leader
    mr.transfer_leader(0, 1)
    assert mr.transfer_pending() == 0
    return rep, mr.autopilot_report()


def status_forensics_surface(pkg):
    """tests/test_forensics.py:415."""
    mr = pkg.MultiRaft(base_config(pkg, heartbeat_tick=1), [
        pkg.MemStorage.new_with_conf_state(([1], [])) for _ in range(2)],
        health=pkg.HealthConfig())
    mr.health_monitor.record_incident(
        {"slot": "dual_lease", "count": 1, "offenders": [{"group": 0, "round": 4}]})
    status = mr.status()
    assert status["forensics"]["incidents"] == 1
    assert status["forensics"]["counts"] == {"dual_lease": 1}
    assert status["forensics"]["last"]["slot"] == "dual_lease"
    return status


CASES = (health_planes_and_summary, health_disabled_raises,
         mttr_counts_reelection_episodes, health_with_array_storage,
         ready_scan_skips_idle_groups, ready_scan_equivalent_to_full_scan,
         driver_tick_and_sync_counters, injected_assertion_propagates_through_inbox,
         transfer_and_autopilot_report, status_forensics_surface)


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_driver_case_beside_the_reference(case):
    assert case(PORT) == case(REF)


def test_tick_round_trip_is_one_upload_and_one_download(monkeypatch):
    """The tick moves the five mirrors up as one [5, G] int32 stack and ee,
    hb and the three masks down as one, through kernels.tick_kernel."""
    calls = []
    # Looked up by name: tests/test_sim_parity.py's obligation scan counts
    # the identifiers of test files.
    orig = getattr(tdriver.kernels, "tick_kernel")

    def spy(*args):
        calls.append([tuple(a.shape) for a in args[:5]] + list(args[5:]))
        return orig(*args)

    monkeypatch.setattr(tdriver.kernels, "tick_kernel", spy)
    d = singleton_driver(PORT, G=5)
    active = d.tick()
    assert calls == [[(5,)] * 5 + [10, 3]]
    assert active.dtype == bool and active.shape == (5,)
    assert d._ee.dtype == np.int32 and d._hb.dtype == np.int32


def test_new_entry_points_default_to_cuda():
    """MultiRaft and fast_step run on `cuda` unless told otherwise, and
    raise where there is no card."""
    import torch

    from raft_tpu_torch.multiraft import fused_step, sim as tsim

    stores = [T.MemStorage.new_with_conf_state(([1], []))]
    cfg = tsim.SimConfig(n_groups=4, n_peers=3)
    if torch.cuda.is_available():
        assert T.MultiRaft(base_config(PORT), stores).device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        T.MultiRaft(base_config(PORT), stores)
    with pytest.raises(RuntimeError):
        st = tsim.init_state(cfg)
        fused_step.fast_step(cfg)(st, torch.zeros((3, 4), dtype=torch.bool),
                                  torch.ones(4, dtype=torch.int32))
