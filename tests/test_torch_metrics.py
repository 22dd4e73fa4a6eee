"""The port's observability layer (raft_tpu_torch/scalar/metrics.py) against
raft_tpu's: the same operations on both Registries expose the same text
and snapshot; the tracers write the same JSONL but for `ts`; the port's
ScalarCluster with the port's Metrics equals the reference's with its
own; and the port's ClusterSim counter plane equals its ScalarCluster's
Metrics counts on tests/test_counter_parity.py's schedules.  Every
comparison is exact."""

import io
import json

import numpy as np
import pytest
import torch

from raft_tpu import metrics as rmetrics
from raft_tpu.config import Config as RConfig
from raft_tpu.eraftpb import MessageType as RMessageType
from raft_tpu.multiraft.simref import ScalarCluster as RScalarCluster
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.simref import ScalarCluster as TScalarCluster
from raft_tpu_torch.scalar import metrics as tmetrics
from raft_tpu_torch.scalar.config import Config as TConfig
from raft_tpu_torch.scalar.eraftpb import MessageType as TMessageType

PKGS = (rmetrics, tmetrics)


def registry_ops(mod):
    """The same sequence of registrations and updates on `mod`'s Registry."""
    r = mod.Registry()
    c = r.counter("ops_total", "Operations", ("kind",))
    c.labels(kind="a").inc()
    c.labels("b").inc(4)
    c.labels(kind='quote"back\\slash\nnl').inc(2)
    g = r.gauge("depth", "Queue depth")
    g.set(7)
    g.inc(3)
    g.labels().dec(1.5)
    h = r.histogram("lat_seconds", "Latency", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.003, 0.003, 0.05, 2.0):
        h.observe(v)
    lh = r.histogram("sized_bytes", "Sizes", ("op",), buckets=(10, 100))
    lh.labels(op="put").observe(5)
    lh.labels(op="get").observe(500)
    assert r.counter("ops_total", "Operations", ("kind",)) is c  # idempotent
    with pytest.raises(ValueError):
        r.gauge("ops_total", "conflict")
    return r


def test_registry_expose_and_snapshot_equal():
    ref, port = (registry_ops(mod) for mod in PKGS)
    assert port.expose() == ref.expose()
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()['ops_total{kind="b"}'] == 4


def facade_ops(mod, mtype):
    """The Metrics facade's hooks, driven the same way in each package."""
    sink = io.StringIO()
    m = mod.Metrics(tracer=mod.EventTracer(sink))
    m.on_send(mtype.MsgAppend)
    m.on_send(mtype.MsgAppend)
    m.on_recv(mtype.MsgRequestVote)
    m.on_driver_tick(n_active=3, n_campaign=1, n_beat=2, n_checkq=0,
                     sync_seconds=0.002)
    m.on_ready_scan(scanned=2, skipped=6)
    m.on_health_summary({
        "counts": {"leaderless": 1, "stalled_leaderless": 0,
                   "commit_stalled": 2, "churning": 0},
        "lag_hist": [4, 1, 0, 0, 0, 0, 0, 3],
        "worst": [{"group": 5, "score": 9}],
    })
    m.tracer.emit("campaign", group=3, term=2)
    m.tracer.emit("commit_advance", group=3, old=0, new=5)
    return m, sink.getvalue()


def test_facade_and_tracer_equal_but_ts():
    (rm, rtext), (tm, ttext) = (facade_ops(mod, mt) for mod, mt in
                                zip(PKGS, (RMessageType, TMessageType)))
    assert tm.registry.expose() == rm.registry.expose()
    assert tm.registry.snapshot() == rm.registry.snapshot()
    rlines = [json.loads(s) for s in rtext.splitlines()]
    tlines = [json.loads(s) for s in ttext.splitlines()]
    assert len(tlines) == len(rlines) > 0
    for a, b in zip(rlines, tlines):
        assert set(a) == set(b)
        a.pop("ts", None)
        b.pop("ts", None)
        assert a == b


def test_tracer_list_and_file_sinks(tmp_path):
    for mod in PKGS:
        events = []
        t = mod.EventTracer(events)
        t.emit("campaign", group=3, term=2)
        assert events[0]["event"] == "campaign" and events[0]["seq"] == 0
    paths = [str(tmp_path / f"trace{i}.jsonl") for i in range(2)]
    for mod, path in zip(PKGS, paths):
        t = mod.EventTracer(path)
        t.emit("state_transition", group=0, id=1, to="Leader")
        t.emit("vote_grant", group=0, id=2, candidate=1)
        t.close()
    a, b = ([json.loads(s) for s in open(p).read().splitlines()] for p in paths)
    for x, y in zip(a, b):
        x.pop("ts", None)
        y.pop("ts", None)
    assert a == b and len(a) == 2


def test_config_metrics_is_the_metrics_class():
    m = tmetrics.Metrics()
    assert TConfig(id=1, metrics=m).metrics is m
    assert (TConfig.__dataclass_fields__["metrics"].type
            == RConfig.__dataclass_fields__["metrics"].type)


@pytest.mark.parametrize("G,P,rounds", [(2, 3, 30), (3, 5, 25)])
def test_scalar_cluster_metrics_equal(G, P, rounds):
    """The port's ScalarCluster with the port's Metrics against the
    reference's with its own: registry text, snapshot and trace (but ts)
    after every round."""
    out = []
    for mod, cls in ((rmetrics, RScalarCluster), (tmetrics, TScalarCluster)):
        events = []
        m = mod.Metrics(tracer=mod.EventTracer(events))
        cluster = cls(G, P, metrics=m)
        rng = np.random.RandomState(G * 10 + P)
        per_round = []
        for r in range(rounds):
            crashed = rng.rand(G, P) < 0.1
            append = rng.randint(0, 3, size=G).astype(np.int64)
            cluster.round(crashed, append)
            per_round.append((m.registry.expose(), len(events)))
        for e in events:
            e.pop("ts", None)
        out.append((per_round, events))
    assert out[1] == out[0]
    assert any(e["event"] == "commit_advance" for e in out[1][1])


def scalar_counts(m):
    return {
        "campaigns": int(m.campaigns.total()),
        "heartbeats": int(m.beats.value),
        "elections_won": int(m.elections_won.value),
        "commit_entries": int(m.commit_entries.value),
    }


def counter_parity(G, P, rounds, schedule):
    """tests/test_counter_parity.py:run_both on the port: its ClusterSim's
    counter plane against its ScalarCluster's Metrics, every round."""
    m = tmetrics.Metrics()
    scalar = TScalarCluster(G, P, metrics=m)
    s = tsim.ClusterSim(tsim.SimConfig(n_groups=G, n_peers=P, collect_counters=True),
                        device="cpu")
    for r in range(rounds):
        crashed, append = schedule(r)
        scalar.round(crashed, append)
        s.run_round(torch.as_tensor(crashed.T.copy()),
                    torch.as_tensor(append, dtype=torch.int32))
        assert s.counters() == scalar_counts(m), f"round {r}"
    return scalar_counts(m)


def test_counter_parity_elections_then_steady_appends():
    G, P = 8, 3
    got = counter_parity(G, P, 40, lambda r: (np.zeros((G, P), bool),
                                              np.full(G, 2, np.int64)))
    assert got["elections_won"] >= G and got["commit_entries"] > 0


def test_counter_parity_bursty_appends_5_peers():
    G, P = 6, 5

    def schedule(r):
        appends = np.array([r % 3 == 0] * G, np.int64) * (1 + r % 2)
        return np.zeros((G, P), bool), appends

    got = counter_parity(G, P, 50, schedule)
    assert got["heartbeats"] > 0
