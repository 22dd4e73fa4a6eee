"""A five-node raft cluster in five threads with mpsc-style mailboxes on the
port's scalar core, counterpart of `examples/five_mem_node.py` (reference:
examples/five_mem_node/main.rs — behavioral port; BASELINE.json config #1).

Node 1 bootstraps via a snapshot at index 1 with itself as the only voter,
then adds nodes 2-5 through ConfChange proposals; after the membership is
complete, 100 client proposals are driven to completion.

Run: python -m raft_tpu_torch.examples.five_mem_node
"""

import queue
import threading
import time

from ..scalar import (
    Config,
    ConfChange,
    ConfChangeType,
    ConfState,
    EntryType,
    MemStorage,
    Message,
    MessageType,
    RawNode,
    Snapshot,
    SnapshotMetadata,
    StateRole,
)
from ..scalar.eraftpb import decode_conf_change
from ..scalar.raw_node import is_local_msg

NUM_NODES = 5
NUM_PROPOSALS = 100


class Proposal:
    def __init__(self, normal=None, conf_change=None):
        self.normal = normal  # (key, value)
        self.conf_change = conf_change
        self.proposed_index = 0
        self.done = threading.Event()
        self.success = False

    def propose_on(self, node: RawNode) -> None:
        last_index = node.raft.raft_log.last_index() + 1
        try:
            if self.normal is not None:
                key, value = self.normal
                node.propose(b"", f"{key}={value}".encode())
            elif self.conf_change is not None:
                node.propose_conf_change(b"", self.conf_change)
        except Exception:
            return
        if node.raft.raft_log.last_index() + 1 == last_index:
            # Proposal was dropped silently.
            return
        self.proposed_index = last_index


class Node(threading.Thread):
    def __init__(self, id, mailboxes, proposals_lock, proposals):
        super().__init__(daemon=True)
        self.id = id
        self.mailboxes = mailboxes
        self.proposals_lock = proposals_lock
        self.proposals = proposals
        self.kv = {}
        self.stop_flag = threading.Event()
        self.raft_group = None
        self.storage = None
        if id == 1:
            self._init_leader()

    def _init_leader(self) -> None:
        # Bootstrap via a snapshot at index 1 whose ConfState contains only
        # node 1 (reference: main.rs:177-196).
        snap = Snapshot(
            metadata=SnapshotMetadata(
                conf_state=ConfState(voters=[1]), index=1, term=1
            )
        )
        self.storage = MemStorage()
        with self.storage.wl() as core:
            core.apply_snapshot(snap)
        self.raft_group = RawNode(self._config(), self.storage)

    def _init_from_message(self, m: Message) -> None:
        """Followers materialize lazily when first contacted
        (reference: main.rs initialize_raft_from_message)."""
        if is_local_msg(m.msg_type) or m.term == 0:
            return
        self.storage = MemStorage()
        self.raft_group = RawNode(self._config(), self.storage)

    def _config(self) -> Config:
        return Config(
            id=self.id,
            election_tick=10,
            heartbeat_tick=3,
            max_size_per_msg=1024 * 1024,
            max_inflight_msgs=256,
            applied=0,
        )

    def step(self, m: Message) -> None:
        if self.raft_group is None:
            self._init_from_message(m)
            if self.raft_group is None:
                return
        try:
            self.raft_group.step(m)
        except Exception:
            pass

    def run(self) -> None:
        tick_interval = 0.01
        last_tick = time.monotonic()
        while not self.stop_flag.is_set():
            # Drain the mailbox.
            try:
                while True:
                    m = self.mailboxes[self.id].get_nowait()
                    self.step(m)
            except queue.Empty:
                pass

            if self.raft_group is None:
                time.sleep(0.001)
                continue

            now = time.monotonic()
            if now - last_tick >= tick_interval:
                self.raft_group.tick()
                last_tick = now

            # The leader drives pending proposals (reference: main.rs:364-418).
            if self.raft_group.raft.state == StateRole.Leader:
                with self.proposals_lock:
                    for p in self.proposals:
                        if p.proposed_index == 0 and not p.done.is_set():
                            p.propose_on(self.raft_group)

            self.on_ready()
            time.sleep(0.0005)

    def on_ready(self) -> None:
        """The full Ready cycle (reference: main.rs:237-346)."""
        node = self.raft_group
        if not node.has_ready():
            return
        rd = node.ready()

        # 1. send messages (leaders pipeline before persisting).
        for m in rd.take_messages():
            self._send(m)
        # 2/3. apply snapshot, append entries, persist hard state.
        if not rd.snapshot.is_empty():
            with self.storage.wl() as core:
                core.apply_snapshot(rd.snapshot.clone())
        if rd.entries:
            with self.storage.wl() as core:
                core.append(rd.entries)
        if rd.hs is not None:
            with self.storage.wl() as core:
                core.set_hardstate(rd.hs.clone())
        # 4. send persisted messages.
        for m in rd.take_persisted_messages():
            self._send(m)
        # 5. apply committed entries.
        committed = rd.take_committed_entries()
        light = node.advance(rd)
        committed.extend(light.take_committed_entries())
        self._apply(committed)
        node.advance_apply()

    def _apply(self, entries) -> None:
        for entry in entries:
            if not entry.data:
                continue  # leader noop
            if entry.entry_type == EntryType.EntryConfChange:
                cc = decode_conf_change(entry.data)
                cs = self.raft_group.apply_conf_change(cc)
                with self.storage.wl() as core:
                    core.set_conf_state(cs)
            else:
                key, value = entry.data.decode().split("=", 1)
                self.kv[int(key)] = value
            # Notify the proposer (only the leader holds proposals).
            if self.raft_group.raft.state == StateRole.Leader:
                with self.proposals_lock:
                    for p in self.proposals:
                        if p.proposed_index == entry.index and not p.done.is_set():
                            p.success = True
                            p.done.set()

    def _send(self, m: Message) -> None:
        try:
            self.mailboxes[m.to].put_nowait(m)
        except KeyError:
            pass


def main() -> None:
    mailboxes = {i: queue.Queue() for i in range(1, NUM_NODES + 1)}
    proposals_lock = threading.Lock()
    proposals = []

    nodes = [Node(i, mailboxes, proposals_lock, proposals) for i in range(1, NUM_NODES + 1)]
    for n in nodes:
        n.start()

    # Elect node 1.
    mailboxes[1].put(Message(msg_type=MessageType.MsgHup, to=1))

    # Add nodes 2..5 via ConfChange (reference: main.rs:421-435).
    for id in range(2, NUM_NODES + 1):
        cc = ConfChange(change_type=ConfChangeType.AddNode, node_id=id)
        p = Proposal(conf_change=cc)
        with proposals_lock:
            proposals.append(p)
        assert p.done.wait(timeout=30), f"adding node {id} timed out"
        print(f"node {id} added to the cluster")

    # Drive client proposals.
    t0 = time.monotonic()
    for i in range(NUM_PROPOSALS):
        p = Proposal(normal=(i, f"value-{i}"))
        with proposals_lock:
            proposals.append(p)
        assert p.done.wait(timeout=30), f"proposal {i} timed out"
    dt = time.monotonic() - t0
    print(f"{NUM_PROPOSALS} proposals committed in {dt:.2f}s "
          f"({NUM_PROPOSALS / dt:.1f} proposals/sec)")

    for n in nodes:
        n.stop_flag.set()
    for n in nodes:
        n.join(timeout=5)

    # Every node that applied everything agrees on the state machine.
    leader_kv = nodes[0].kv
    assert len(leader_kv) == NUM_PROPOSALS
    print("five_mem_node OK")


if __name__ == "__main__":
    main()
