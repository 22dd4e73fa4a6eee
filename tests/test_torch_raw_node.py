"""The port's RawNode and Ready protocol (raft_tpu_torch/scalar/raw_node.py)
against raft_tpu's, by a seeded differential test: 3-peer clusters, one
per package, run the same 200 operations (a tick of every node; propose,
propose_conf_change, campaign, read_index or transfer_leader at one node;
message delivery with drops; the ready/advance/advance_apply cycle of
every node), and every
Ready and LightReady, encoded with each package's own codec, every raised
error and every Status must be equal.  8 seeds for each combination of
pre_vote, check_quorum and ReadOnlyOption (LeaseBased needs check_quorum).
Exact.

`ready_record` and `status_record` are shared with test_torch_driver.py."""

import types

import numpy as np
import pytest

import raft_tpu
from raft_tpu import codec as rcodec
from raft_tpu import eraftpb as reraftpb
from raft_tpu import status as rstatus
from raft_tpu.read_only import ReadOnlyOption as RReadOnlyOption
import raft_tpu_torch.scalar as tscalar
from raft_tpu_torch.scalar import codec as tcodec
from raft_tpu_torch.scalar import eraftpb as teraftpb
from raft_tpu_torch.scalar import status as tstatus
from raft_tpu_torch.scalar.config import Config as TConfig
from raft_tpu_torch.scalar.errors import ConfigInvalid as TConfigInvalid
from raft_tpu_torch.scalar.raft_log import NO_LIMIT as T_NO_LIMIT
from raft_tpu_torch.scalar.raw_node import RawNode as TRawNode
from raft_tpu_torch.scalar.read_only_option import ReadOnlyOption as TReadOnlyOption
from raft_tpu_torch.scalar.storage import MemStorage as TMemStorage

REF = types.SimpleNamespace(
    name="raft_tpu", Config=raft_tpu.Config, MemStorage=raft_tpu.MemStorage,
    RawNode=raft_tpu.RawNode, pb=reraftpb, codec=rcodec, NO_LIMIT=raft_tpu.NO_LIMIT,
    ReadOnlyOption=RReadOnlyOption, Status=rstatus.Status,
    ConfigInvalid=raft_tpu.ConfigInvalid)
PORT = types.SimpleNamespace(
    name="raft_tpu_torch", Config=TConfig, MemStorage=TMemStorage,
    RawNode=TRawNode, pb=teraftpb, codec=tcodec, NO_LIMIT=T_NO_LIMIT,
    ReadOnlyOption=TReadOnlyOption, Status=tstatus.Status,
    ConfigInvalid=TConfigInvalid)
PEERS = [1, 2, 3]
OPS = 200
SEEDS = range(8)


def entries_bytes(pkg, ents):
    """A list of entries as codec bytes (carried by an empty message)."""
    return pkg.codec.encode_message(pkg.pb.Message(entries=list(ents)))


def messages_bytes(pkg, msgs):
    return [pkg.codec.encode_message(m) for m in msgs]


def light_record(pkg, light):
    return ("light", light.commit_index,
            entries_bytes(pkg, light.committed_entries),
            messages_bytes(pkg, light.messages))


def ready_record(pkg, rd):
    """Everything a Ready carries, as plain values and codec bytes."""
    return (
        "ready", rd.number,
        None if rd.ss is None else (rd.ss.leader_id, int(rd.ss.raft_state)),
        None if rd.hs is None else pkg.codec.encode_hard_state(rd.hs),
        [(r.index, r.request_ctx) for r in rd.read_states],
        entries_bytes(pkg, rd.entries),
        pkg.codec.encode_snapshot(rd.snapshot),
        rd.is_persisted_msg, rd.must_sync,
        light_record(pkg, rd.light),
    )


def status_record(pkg, status):
    progress = None
    if status.progress is not None:
        progress = sorted(
            (id, pr.matched, pr.next_idx, int(pr.state), pr.paused,
             pr.pending_snapshot, pr.recent_active)
            for id, pr in status.progress.iter())
    return ("status", status.id, pkg.codec.encode_hard_state(status.hs),
            status.ss.leader_id, int(status.ss.raft_state), status.applied,
            progress)


def make_schedule(seed):
    """OPS operations drawn with numpy: (kind, node, argument)."""
    rng = np.random.RandomState(seed)
    kinds, weights = zip(("tick", 24), ("deliver", 24), ("ready", 24),
                         ("propose", 12), ("conf", 3), ("campaign", 2),
                         ("read_index", 8), ("transfer", 3))
    p = np.array(weights) / sum(weights)
    ops = []
    for i in range(OPS):
        kind = kinds[rng.choice(len(kinds), p=p)]
        node = int(rng.randint(1, 4))
        if kind == "deliver":
            arg = [bool(x) for x in rng.rand(int(rng.randint(1, 30))) < 0.1]
        elif kind == "transfer":
            arg = int(rng.randint(1, 4))
        elif kind == "conf":
            arg = bool(rng.rand() < 0.5)
        else:
            arg = i
        ops.append((kind, node, arg))
    return ops


class Cluster:
    """Three RawNodes of one package over MemStorage, with a FIFO of
    messages in flight."""

    def __init__(self, pkg, pre_vote, check_quorum, lease):
        self.pkg = pkg
        self.stores, self.nodes = {}, {}
        for id in PEERS:
            cfg = pkg.Config(
                id=id, election_tick=10, heartbeat_tick=1, pre_vote=pre_vote,
                check_quorum=check_quorum, max_size_per_msg=pkg.NO_LIMIT,
                max_inflight_msgs=256, timeout_seed=7,
                read_only_option=(pkg.ReadOnlyOption.LeaseBased if lease
                                  else pkg.ReadOnlyOption.Safe))
            self.stores[id] = pkg.MemStorage.new_with_conf_state((PEERS, []))
            self.nodes[id] = pkg.RawNode(cfg, self.stores[id])
        self.inflight = []

    def ready_cycle(self, id):
        """One Ready/advance/advance_apply cycle on node `id`; conf-change
        entries are applied as they commit."""
        pkg, node, store = self.pkg, self.nodes[id], self.stores[id]
        if not node.has_ready():
            return [("no ready",)]
        out = []
        rd = node.ready()
        out.append(ready_record(pkg, rd))
        self.inflight += rd.take_messages()
        with store.wl() as core:
            if not rd.snapshot.is_empty():
                core.apply_snapshot(rd.snapshot.clone())
            if rd.entries:
                core.append(rd.entries)
            if rd.hs is not None:
                core.set_hardstate(rd.hs.clone())
        self.inflight += rd.persisted_messages()
        committed = rd.take_committed_entries()
        light = node.advance(rd)
        out.append(light_record(pkg, light))
        self.inflight += light.take_messages()
        committed += light.take_committed_entries()
        for e in committed:
            if e.entry_type == pkg.pb.EntryType.EntryConfChange:
                cc = pkg.pb.decode_conf_change(e.data)
                out.append(("applied", self.call(lambda: node.apply_conf_change(cc))))
        node.advance_apply()
        out.append(status_record(pkg, node.status()))
        return out

    @staticmethod
    def call(fn):
        """fn()'s outcome: its result's repr, or the error's type name."""
        try:
            res = fn()
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            return ("error", type(e).__name__)
        return ("ok", None if res is None else repr(res))

    def run(self, op):
        kind, id, arg = op
        pkg, node = self.pkg, self.nodes[id]
        if kind == "tick":  # one logical tick: every node
            return [self.call(n.tick) for n in self.nodes.values()]
        if kind == "propose":
            return [self.call(lambda: node.propose(b"", b"op%d" % arg))]
        if kind == "conf":
            cc = pkg.pb.ConfChange(
                change_type=(pkg.pb.ConfChangeType.AddLearnerNode if arg
                             else pkg.pb.ConfChangeType.RemoveNode), node_id=4)
            return [self.call(lambda: node.propose_conf_change(b"", cc))]
        if kind == "campaign":
            return [self.call(node.campaign)]
        if kind == "read_index":
            return [self.call(lambda: node.read_index(b"rd%d" % arg))]
        if kind == "transfer":
            return [self.call(lambda: node.transfer_leader(arg))]
        if kind == "ready":  # node `id` first, then the others
            return [r for i in PEERS[id - 1:] + PEERS[:id - 1]
                    for r in self.ready_cycle(i)]
        assert kind == "deliver"
        out = []
        for drop in arg:
            if not self.inflight:
                break
            m = self.inflight.pop(0)
            if drop or m.to not in self.nodes:
                out.append(("dropped", pkg.codec.encode_message(m)))
                continue
            out.append(("step", pkg.codec.encode_message(m),
                        self.call(lambda: self.nodes[m.to].step(m))))
        return out


COMBOS = [(pv, cq, False) for pv in (False, True) for cq in (False, True)]
COMBOS += [(pv, True, True) for pv in (False, True)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pre_vote,check_quorum,lease", COMBOS,
                         ids=[f"pv{int(a)}-cq{int(b)}-{'lease' if c else 'safe'}"
                              for a, b, c in COMBOS])
def test_raw_node_differential(pre_vote, check_quorum, lease, seed):
    ref, port = (Cluster(pkg, pre_vote, check_quorum, lease) for pkg in (REF, PORT))
    readies = 0
    for i, op in enumerate(make_schedule(seed * 31 + 7)):
        want, got = ref.run(op), port.run(op)
        assert got == want, f"op {i} {op}"
        readies += sum(1 for r in got if r[0] == "ready")
    for id in PEERS:
        assert (status_record(PORT, port.nodes[id].status())
                == status_record(REF, ref.nodes[id].status()))
    assert readies > 0


def test_lease_reads_without_check_quorum_are_refused_alike():
    for pkg in (REF, PORT):
        cfg = pkg.Config(id=1, read_only_option=pkg.ReadOnlyOption.LeaseBased,
                         check_quorum=False)
        with pytest.raises(pkg.ConfigInvalid):
            pkg.RawNode(cfg, pkg.MemStorage.new_with_conf_state((PEERS, [])))


def test_package_exports_the_scalar_api():
    """raft_tpu_torch re-exports what raft_tpu/__init__.py does."""
    import raft_tpu_torch

    missing = [n for n in raft_tpu.__all__ if not hasattr(raft_tpu_torch, n)]
    assert missing == []
    assert raft_tpu_torch.RawNode is TRawNode and tscalar.RawNode is TRawNode
