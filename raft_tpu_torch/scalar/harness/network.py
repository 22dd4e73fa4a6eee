"""Simulated network of Raft peers (reference: harness/src/network.rs)."""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Tuple

from ..config import Config
from ..eraftpb import ConfState, Message, MessageType
from ..errors import RaftError
from ..raft import Raft
from ..raft_log import NO_LIMIT
from ..storage import MemStorage
from .interface import Interface


class Network:
    """reference: network.rs:43-226"""

    def __init__(self) -> None:
        self.peers: Dict[int, Interface] = {}
        self.storage: Dict[int, MemStorage] = {}
        self.dropm: Dict[Tuple[int, int], float] = {}
        self.ignorem: Dict[MessageType, bool] = {}
        # Deterministic RNG for drop probabilities (the reference uses
        # rand::random; we pin a seed so failures reproduce).
        self.rng = random.Random(0x5EED)

    @staticmethod
    def default_config() -> Config:
        """reference: network.rs:56-64"""
        return Config(
            election_tick=10,
            heartbeat_tick=1,
            max_size_per_msg=NO_LIMIT,
            max_inflight_msgs=256,
        )

    @classmethod
    def new(cls, peers: List[Optional[Interface]]) -> "Network":
        """Build a network; None peers become fresh Rafts configured with all
        peer IDs (reference: network.rs:72-75)."""
        return cls.new_with_config(peers, cls.default_config())

    @classmethod
    def new_with_config(
        cls, peers: List[Optional[Interface]], config: Config
    ) -> "Network":
        """reference: network.rs:78-115"""
        net = cls()
        peer_addrs = list(range(1, len(peers) + 1))
        for p, id in zip(peers, peer_addrs):
            if p is None:
                conf_state = ConfState(voters=list(peer_addrs))
                store = MemStorage.new_with_conf_state(conf_state)
                net.storage[id] = store
                c = Config(**{**config.__dict__, "id": id})
                net.peers[id] = Interface(Raft(c, store))
            else:
                if p.raft is not None:
                    if p.raft.id != id:
                        raise AssertionError(
                            f"peer {p.raft.id} in peers has a wrong position"
                        )
                    net.storage[id] = p.raft.raft_log.store
                net.peers[id] = p
        return net

    def ignore(self, t: MessageType) -> None:
        """reference: network.rs:118-120"""
        self.ignorem[t] = True

    def filter(self, msgs: Iterable[Message]) -> List[Message]:
        """Apply ignore/drop rules (reference: network.rs:123-147)."""
        out = []
        for m in msgs:
            if self.ignorem.get(m.msg_type, False):
                continue
            assert m.msg_type != MessageType.MsgHup, "unexpected msgHup"
            perc = self.dropm.get((m.from_, m.to), 0.0)
            if self.rng.random() >= perc:
                out.append(m)
        return out

    def read_messages(self) -> List[Message]:
        """Unfiltered drain of every peer's outbox (reference: network.rs:152-157)."""
        out: List[Message] = []
        for _, peer in self.peers.items():
            out.extend(peer.read_messages())
        return out

    def send(self, msgs: List[Message]) -> None:
        """Synchronous message pump to quiescence, persisting before sending
        (reference: network.rs:162-178)."""
        msgs = list(msgs)
        while msgs:
            new_msgs: List[Message] = []
            for m in msgs:
                p = self.peers[m.to]
                # Only protocol-level step errors are ignored, exactly like
                # the reference's `let _ = p.step(m)` (reference:
                # harness/src/network.rs:169); anything else (assertion,
                # type error) is a harness-caught bug and must propagate.
                try:
                    p.step(m)
                except RaftError:
                    pass
                p.persist()
                new_msgs.extend(self.filter(p.read_messages()))
            msgs = new_msgs

    def filter_and_send(self, msgs: List[Message]) -> None:
        """reference: network.rs:181-183"""
        self.send(self.filter(msgs))

    def dispatch(self, messages: Iterable[Message]) -> None:
        """Deliver without gathering responses; errors propagate
        (reference: network.rs:188-195)."""
        for message in self.filter(messages):
            self.peers[message.to].step(message)

    def drop(self, from_: int, to: int, perc: float) -> None:
        """reference: network.rs:200-202"""
        self.dropm[(from_, to)] = perc

    def cut(self, one: int, other: int) -> None:
        """reference: network.rs:205-208"""
        self.drop(one, other, 1.0)
        self.drop(other, one, 1.0)

    def isolate(self, id: int) -> None:
        """reference: network.rs:211-219"""
        for i in range(len(self.peers)):
            nid = i + 1
            if nid != id:
                self.drop(id, nid, 1.0)
                self.drop(nid, id, 1.0)

    def recover(self) -> None:
        """reference: network.rs:222-225"""
        self.dropm = {}
        self.ignorem = {}
