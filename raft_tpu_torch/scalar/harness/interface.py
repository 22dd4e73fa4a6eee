"""Simulated Raft facade (reference: harness/src/interface.rs).

Wraps an optional `Raft`; a None raft black-holes everything (the reference's
NOP_STEPPER pattern, test_util/mod.rs:25).  Attribute access forwards to the
wrapped raft, standing in for the reference's Deref impls.
"""

from __future__ import annotations

from typing import List, Optional

from ..eraftpb import Message
from ..raft import Raft


class Interface:
    def __init__(self, raft: Optional[Raft]):
        self.raft = raft

    def __getattr__(self, name):
        # Forward everything else to the wrapped Raft (Deref equivalent).
        raft = object.__getattribute__(self, "raft")
        if raft is None:
            raise AttributeError(f"NOP interface has no attribute {name!r}")
        return getattr(raft, name)

    def step(self, m: Message) -> None:
        """Forward one message to the wrapped raft; a None raft black-holes
        it.  (The reference has no Interface::step — Deref forwards to Raft,
        and the harness pump steps peers at harness/src/network.rs:169.)"""
        if self.raft is not None:
            self.raft.step(m)

    def read_messages(self) -> List[Message]:
        """reference: interface.rs:49-54"""
        if self.raft is not None:
            msgs, self.raft.msgs = self.raft.msgs, []
            return msgs
        return []

    def persist(self) -> None:
        """Persist unstable snapshot + entries into the MemStorage and notify
        the raft (reference: interface.rs:57-75)."""
        if self.raft is None:
            return
        r = self.raft
        snapshot = r.raft_log.unstable_snapshot()
        if snapshot is not None:
            snap = snapshot.clone()
            index = snap.metadata.index
            r.raft_log.stable_snap(index)
            with r.store.wl() as core:
                core.apply_snapshot(snap)
            r.on_persist_snap(index)
            r.commit_apply(index)
        unstable = list(r.raft_log.unstable_entries())
        if unstable:
            last = unstable[-1]
            last_idx, last_term = last.index, last.term
            r.raft_log.stable_entries(last_idx, last_term)
            with r.store.wl() as core:
                core.append(unstable)
            r.on_persist_entries(last_idx, last_term)


def NOP_STEPPER() -> Interface:
    """A black-hole peer (reference: harness/tests/test_util/mod.rs:25)."""
    return Interface(None)
