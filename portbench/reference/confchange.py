"""The conf-change arm of the reference: membership changes run around the
plain round of `raft_step.py`, one protocol round at a time, in plain
PyTorch.  It imports nothing of the program.

A request (the traffic's `confchanges`) starts a chain of conf changes in
some groups: PD's operators in plain masks, each step a target
configuration (incoming voters, outgoing voters, learners; bool [P, G]).
PD's move-peer is four steps: add a learner, enter a joint configuration
that promotes it and demotes the source, leave the joint configuration,
remove the demoted peer.  A step whose target has no voter ends the chain.

Each group runs its chain by the protocol of raft-rs's conf changes, as
the program under test batches it (its reconfig runner; the program's
state exposes the fields below under the same names):

  propose  the next step's conf entry is appended last at the acting
           leader once the previous step has applied (raft-rs:
           RawNode::propose_conf_change, one entry in flight as
           `pending_conf_index` allows); with no alive leader nothing is
           appended and the step proposes again the next round (raft-rs
           drops the proposal, and PD retries the step);
  wait     the entry applies once its owner still leads at the term it
           proposed in, is alive, and its commit covers the entry; under a
           joint configuration that commit already needed both majorities
           (raft-rs: JointConfig::committed_index);
  retry    a deposed or crashed owner abandons the entry, and the step
           proposes again at the next leader (raft-rs's next leader could
           commit and apply the old entry from its log; here the log holds
           it, inert);
  apply    at the round's end the group's masks become the step's target
           for every peer at once (raft-rs: each peer's
           Raft::apply_conf_change when it applies the entry, through
           confchange::Changer into ProgressTracker::apply_conf), with
           post_conf_change's reactions: see `apply_conf`.

The per-group protocol state is `State`; its fields and the round's are
what the check compares in traffic with conf changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import raft_step as R

I32 = torch.int32
# The deepest chain a request may carry: PD's move-peer, its longest
# operator made of conf changes.
STEPS = 4


class State(NamedTuple):
    """Each group's conf-change protocol state (int32[G] unless marked)."""

    cc_stage: torch.Tensor  # 0: the next step (if any) proposes; 1: its entry is in flight
    cc_step: torch.Tensor  # the next unapplied step of the group's chain
    cc_owner: torch.Tensor  # the proposing leader's 1-based slot (0: none yet)
    cc_index: torch.Tensor  # the in-flight entry's log index
    cc_term: torch.Tensor  # the owner's term when it proposed
    cc_len: torch.Tensor  # the steps of the group's chain (0: none)
    cc_voter: torch.Tensor  # bool[STEPS, P, G]: each step's incoming voters
    cc_outgoing: torch.Tensor  # bool[STEPS, P, G]: its outgoing voters (joint)
    cc_learner: torch.Tensor  # bool[STEPS, P, G]: its learners


FIELDS = State._fields


def init_state(n_peers: int, n_groups: int, device) -> State:
    """No chain in any group."""
    z = torch.zeros((n_groups,), dtype=I32, device=device)
    m = torch.zeros((STEPS, n_peers, n_groups), dtype=torch.bool, device=device)
    return State(z, z.clone(), z.clone(), z.clone(), z.clone(), z.clone(), m, m.clone(),
                 m.clone())


def of(st) -> State:
    """The conf-change fields of any state that has them."""
    return State(**{f: getattr(st, f) for f in FIELDS})


def chain_steps(voter: torch.Tensor) -> torch.Tensor:
    """int64[G]: the steps of each group's chain, bool [K, P, G] targets:
    the leading steps whose target has a voter."""
    has = voter.any(1).to(torch.int64)
    return torch.cumprod(has, 0).sum(0)


def start(cc: State, req) -> State:
    """The chains a request starts: each group of `req.start` with no chain
    running takes the request's targets (padded to STEPS); a group whose
    chain still runs keeps it and ignores the request."""
    K = req.voter.shape[0]
    if K > STEPS:
        raise ValueError(f"a chain of {K} steps; at most {STEPS}")
    idle = (cc.cc_step >= cc.cc_len) & (cc.cc_stage == 0)
    take = req.start & idle

    def pad(m):
        out = torch.zeros_like(cc.cc_voter)
        out[:K] = m
        return out

    tv, to, tl = pad(req.voter), pad(req.outgoing), pad(req.learner)
    t3 = take[None, None, :]
    return cc._replace(
        cc_stage=torch.where(take, 0, cc.cc_stage),
        cc_step=torch.where(take, 0, cc.cc_step),
        cc_len=torch.where(take, chain_steps(tv).to(I32), cc.cc_len),
        cc_voter=torch.where(t3, tv, cc.cc_voter),
        cc_outgoing=torch.where(t3, to, cc.cc_outgoing),
        cc_learner=torch.where(t3, tl, cc.cc_learner),
    )


def at_peer(plane: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """plane[slot - 1, g] for a 1-based slot int32[G] (0 reads slot 1)."""
    i = torch.clamp(slot - 1, 0, plane.shape[0] - 1).to(torch.int64)
    return plane.gather(0, i[None, :])[0]


def at_step(plane: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """plane[step[g], :, g] of a bool [STEPS, P, G] plane."""
    i = torch.clamp(step, 0, plane.shape[0] - 1).to(torch.int64)
    return plane.gather(0, i[None, None, :].expand(1, plane.shape[1], plane.shape[2]))[0]


def apply_conf(st: R.State, new_voter, new_outgoing, new_learner, apply) -> R.State:
    """The masks of the groups in `apply` (bool[G]) become the targets, with
    what raft-rs does around the swap:

    - ProgressTracker::apply_conf: a peer new to the configuration (in
      none of the old incoming, outgoing or learner sets) gets a fresh
      Progress, matched 0 and recent_active true; a peer that leaves all
      of them loses its Progress.  The program keeps a tracker row under
      every peer, so the column is reset under every owner.
    - post_conf_change: a leader whose incoming and outgoing voters both
      lost it stops leading.  raft-rs leaves such a leader as it is (its
      source marks stepping down as a TODO); the program steps down every
      peer above follower that is no longer promotable, leader_id 0.
    - post_conf_change's maybe_commit: a leader recomputes its commit over
      its own tracker row under the new majorities (JointConfig::
      committed_index, an empty outgoing half committing everything) and
      takes it where it is of its own term (raft_log.maybe_commit), so a
      quorum that shrank commits at once.  The program does this at every
      leader of the group; raft-rs at the one leader it has."""
    ap = apply[None, :]
    old = st.voter_mask | st.outgoing_mask | st.learner_mask
    vm = torch.where(ap, new_voter, st.voter_mask)
    om = torch.where(ap, new_outgoing, st.outgoing_mask)
    lm = torch.where(ap, new_learner, st.learner_mask)
    new = vm | om | lm
    added = ap & new & ~old
    removed = ap & old & ~new
    matched = torch.where((added | removed)[None, :, :], 0, st.matched)
    ra = st.recent_active
    if ra is not None:
        ra = torch.where(added[None, :, :], True,
                         torch.where(removed[None, :, :], False, ra))
    down = ap & (st.state != R.ROLE_FOLLOWER) & ~(vm | om)
    state = torch.where(down, R.ROLE_FOLLOWER, st.state)
    leader_id = torch.where(down, 0, st.leader_id)
    rows = matched.transpose(1, 2)  # [owner, G, peer]: each owner's tracker row
    mci = torch.minimum(R.committed_index(rows, vm.t()[None].expand(rows.shape)),
                        R.committed_index(rows, om.t()[None].expand(rows.shape)))
    pickup = ap & (state == R.ROLE_LEADER) & (mci >= st.term_start_index) & (mci < R.INF)
    commit = torch.where(pickup, torch.maximum(st.commit, mci), st.commit)
    return st._replace(state=state, leader_id=leader_id, commit=commit, matched=matched,
                       voter_mask=vm, outgoing_mask=om, learner_mask=lm, recent_active=ra)


class Arm:
    """The protocol's round around a plain round `step` (raft_step.step by
    default).  Each part is a method of its own, so that a planted fault
    (portbench/controls.py) replaces one part alone."""

    def __init__(self, step=R.step):
        self.step = step

    def propose(self, rc, st, cc, crashed, append):
        """The round itself, with each due step's entry appended last at the
        acting leader: (state after the round, where the entries landed:
        got bool[G], owner, index, term int32[G])."""
        due = (cc.cc_step < cc.cc_len) & (cc.cc_stage == 0)
        lead: list = []
        st2 = self.step(rc, st, crashed, append + due.to(I32), lead=lead)
        has_leader, first_l, lead_last, lead_term = lead[0]
        got = due & has_leader
        return st2, got, first_l + 1, lead_last, lead_term

    def gate(self, st2, cc, crashed):
        """(apply, retry) bool[G] for the entries in flight after the round."""
        owner = cc.cc_owner
        own_lead = ((at_peer(st2.state, owner) == R.ROLE_LEADER)
                    & (at_peer(st2.term, owner) == cc.cc_term)
                    & ~at_peer(crashed, owner))
        committed = at_peer(st2.commit, owner) >= cc.cc_index
        flying = cc.cc_stage == 1
        return flying & own_lead & committed, flying & ~own_lead

    def apply(self, st2, cc, apply):
        return apply_conf(st2, at_step(cc.cc_voter, cc.cc_step),
                          at_step(cc.cc_outgoing, cc.cc_step),
                          at_step(cc.cc_learner, cc.cc_step), apply)

    def round(self, rc, st: R.State, cc: State, crashed, append):
        """One protocol round of every group: (state, conf-change state)."""
        st2, got, owner, index, term = self.propose(rc, st, cc, crashed, append)
        cc = cc._replace(
            cc_stage=torch.where(got, 1, cc.cc_stage),
            cc_owner=torch.where(got, owner, cc.cc_owner),
            cc_index=torch.where(got, index, cc.cc_index),
            cc_term=torch.where(got, term, cc.cc_term),
        )
        apply, retry = self.gate(st2, cc, crashed)
        st3 = self.apply(st2, cc, apply)
        cc = cc._replace(cc_stage=torch.where(apply | retry, 0, cc.cc_stage),
                         cc_step=torch.where(apply, cc.cc_step + 1, cc.cc_step))
        return st3, cc

    def run(self, rc, st: R.State, cc: State, crashed, append, rounds: int,
            req: Optional[object] = None):
        """A block: the request's chains start, then `rounds` rounds."""
        if req is not None:
            cc = start(cc, req)
        for _ in range(rounds):
            st, cc = self.round(rc, st, cc, crashed, append)
        return st, cc
