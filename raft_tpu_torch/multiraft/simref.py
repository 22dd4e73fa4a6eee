"""ScalarCluster: G groups x P real scalar `Raft`s in lockstep rounds.

Counterpart of `raft_tpu/multiraft/simref.py` (:40-235, `ScalarCluster`
with `timeout_seed_base=`), on the port's own scalar copy
(`raft_tpu_torch/scalar/`).  Each group runs P real `Raft` instances
through the harness Network's persist-before-send pump, one protocol round
at a time, with the same (node, term)-keyed deterministic timeouts as the
device sim.  A round is: tick every peer (in peer order), pump to
quiescence, propose the round's append workload at the acting leader,
pump.  The forensics replay (forensics.replay) runs one offending group of
a device run through it on that group's global timeout stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..scalar.config import Config
from ..scalar.eraftpb import ConfState, Entry, Message, MessageType
from ..scalar.harness import Interface, Network
from ..scalar.raft import StateRole
from ..scalar.raft_log import NO_LIMIT
from ..scalar.storage import MemStorage


class ScalarCluster:
    def __init__(self, n_groups: int, n_peers: int, election_tick: int = 10,
                 heartbeat_tick: int = 1, voters=None, voters_outgoing=None,
                 learners=None, check_quorum: bool = False,
                 pre_vote: bool = False, metrics=None,
                 timeout_seed_base: int = 0):
        """`voters`/`voters_outgoing`/`learners` (peer-id lists) bootstrap
        every group in that (possibly joint) configuration; default: all
        peers voters.  `check_quorum`/`pre_vote` configure every Raft the
        reference way (raft.rs Config), as SimConfig's flags of the same
        names configure the device sim.  `metrics` (an optional
        scalar.metrics.Metrics) is shared by every Raft in the cluster.  `timeout_seed_base` offsets every group's timeout_seed
        (group g draws from stream timeout_seed_base + g): the forensics
        one-group repro (forensics.replay) runs global group g as a
        one-group cluster on stream g, the twin of the device run."""
        self.n_groups = n_groups
        self.n_peers = n_peers
        self.networks: List[Network] = []
        for g in range(n_groups):
            config = Config(
                election_tick=election_tick,
                heartbeat_tick=heartbeat_tick,
                max_size_per_msg=NO_LIMIT,
                max_inflight_msgs=1 << 20,  # effectively unbounded window
                timeout_seed=timeout_seed_base + g,
                check_quorum=check_quorum,
                pre_vote=pre_vote,
                metrics=metrics,
            )
            if voters is None:
                peers: List[Optional[Interface]] = [None] * n_peers
                self.networks.append(Network.new_with_config(peers, config))
            else:
                from ..scalar.raft import Raft

                ifaces = []
                for id in range(1, n_peers + 1):
                    cs = ConfState(
                        voters=list(voters),
                        voters_outgoing=list(voters_outgoing or []),
                        learners=list(learners or []),
                    )
                    store = MemStorage.new_with_conf_state(cs)
                    cfg = Config(**{**config.__dict__, "id": id})
                    ifaces.append(Interface(Raft(cfg, store)))
                self.networks.append(
                    Network.new_with_config(ifaces, config)
                )

    def _apply_crash_mask(
        self,
        net: Network,
        crashed_row: Sequence[bool],
        link_row: Optional[np.ndarray] = None,
    ) -> None:
        """Install the round's faults as per-edge drops: whole-peer crashes
        (isolation) plus, when a `link_row[P, P]` reachability matrix is
        given, a 1.0 drop on every down DIRECTED link — the scalar half of
        the chaos engine's link plane (sim.step's `link=`)."""
        net.recover()
        for p, c in enumerate(crashed_row):
            if c:
                net.isolate(p + 1)
        if link_row is not None:
            for a in range(self.n_peers):
                for b in range(self.n_peers):
                    if a != b and not link_row[a, b]:
                        net.drop(a + 1, b + 1, 1.0)

    def round(self, crashed: Optional[np.ndarray] = None,
              append_n: Optional[np.ndarray] = None,
              link: Optional[np.ndarray] = None,
              conf_propose: Optional[np.ndarray] = None,
              kick: Optional[np.ndarray] = None):
        """One lockstep protocol round across all groups.

        crashed:  bool[G, P] whole-peer isolation for the round.
        append_n: int[G] workload proposed at each group's acting leader.
        link:     optional bool[P, P, G] directed reachability (peer-major
                  src/dst axes, like the device plane); a down link drops
                  every message on that edge for the whole round.
        conf_propose: optional bool[G] — groups whose pending conf-change
                  op proposes its entry this round (the scalar twin of
                  sim.step's reconfig_propose): ONE extra entry joins the
                  group's propose batch, appended LAST.  Returns a list of
                  per-group (owner, index, term) records — the acting
                  leader's id, the conf entry's log index, and the
                  leader's term at propose time, or (0, 0, 0) where no
                  alive leader acted — mirroring sim.ReconfigProposal
                  bit-for-bit.  Returns None when conf_propose is None.
        kick:     optional bool[G, P] — the autopilot campaign kick (the
                  scalar twin of sim.step's campaign_kick): a MsgHup
                  stepped at the peer right after its tick, i.e. the
                  RawNode::campaign admin call.  A kick lands only when
                  the peer's own election timer did NOT fire this tick
                  (the device ORs the two into one campaign), and MsgHup
                  itself enforces the leader/promotable gates (hup()).
        """
        if crashed is None:
            crashed = np.zeros((self.n_groups, self.n_peers), dtype=bool)
        if append_n is None:
            append_n = np.zeros((self.n_groups,), dtype=np.int64)
        props = (
            None
            if conf_propose is None
            else [(0, 0, 0)] * self.n_groups
        )
        for g, net in enumerate(self.networks):
            self._apply_crash_mask(
                net, crashed[g], None if link is None else link[:, :, g]
            )
            # Tick every peer in peer order, collecting outbound messages
            # with the pump's persist-before-send discipline.
            initial: List[Message] = []
            for p in range(1, self.n_peers + 1):
                peer = net.peers[p]
                fired = (
                    peer.raft.state != StateRole.Leader
                    and peer.raft.promotable
                    and peer.raft.election_elapsed + 1
                    >= peer.raft.randomized_election_timeout
                )
                peer.raft.tick()
                if kick is not None and bool(kick[g][p - 1]) and not fired:
                    peer.raft.step(
                        Message(msg_type=MessageType.MsgHup, from_=p, to=p)
                    )
                peer.persist()
                initial.extend(net.filter(peer.read_messages()))
            net.send(initial)
            # Propose the append workload at the acting leader (the alive
            # leader with the highest term).
            n = int(append_n[g])
            extra = conf_propose is not None and bool(conf_propose[g])
            total = n + (1 if extra else 0)
            if total > 0:
                lead = self.acting_leader(g, crashed[g])
                if lead is not None:
                    if extra:
                        # The conf entry's landing spot, captured BEFORE
                        # the propose pump (the leader appends the batch
                        # first thing; later traffic in the pump can
                        # depose it but never unappend) — matches the
                        # device extra's workload-stage snapshot.
                        r = net.peers[lead].raft
                        props[g] = (
                            lead,
                            r.raft_log.last_index() + total,
                            r.term,
                        )
                    ents = [Entry(data=b"x") for _ in range(total)]
                    net.send([
                        Message(
                            msg_type=MessageType.MsgPropose,
                            from_=lead,
                            to=lead,
                            entries=ents,
                        )
                    ])
        return props

    def acting_leader(self, g: int, crashed_row: Sequence[bool]) -> Optional[int]:
        best = None
        best_term = -1
        for p in range(1, self.n_peers + 1):
            if crashed_row[p - 1]:
                continue
            r = self.networks[g].peers[p].raft
            if r.state == StateRole.Leader and r.term > best_term:
                best, best_term = p, r.term
        return best

    # --- state extraction for parity comparison ---

    def snapshot(self) -> dict:
        G, P = self.n_groups, self.n_peers
        out = {
            k: np.zeros((G, P), dtype=np.int64)
            for k in ("term", "state", "commit", "last_index", "last_term")
        }
        for g in range(G):
            for p in range(P):
                r = self.networks[g].peers[p + 1].raft
                out["term"][g, p] = r.term
                out["state"][g, p] = r.state
                out["commit"][g, p] = r.raft_log.committed
                out["last_index"][g, p] = r.raft_log.last_index()
                out["last_term"][g, p] = r.raft_log.last_term()
        return out
