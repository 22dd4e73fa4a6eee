"""What decides `correct`: the program's states against the plain
reference's, and the configuration's guarantees.

Nothing here imports the program.  A state is read by its field names
(`reference.raft_step.FIELDS`, and in traffic with conf changes the
protocol's `reference.confchange.FIELDS` too), so the program's states and
the reference's compare plane by plane.

The reference follows the program block by block from the program's own
state: it cannot replay a whole window (over a hundred thousand rounds of
a million groups in its plain PyTorch round), so for each block in a
sample drawn from the seed it runs the block's k rounds from the program's
input state and compares every plane of the output, every group.  The two
stages this skips are checked by themselves: the start (the reference
settles the fleet from its own initial state and must reach the program's
settled state), and the blocks that are not sampled (the guarantees on the
window's last state, and, where the traffic has no faults, every group's
appended entries over the whole window).

A configuration may state its membership (`voters`, `learners`); the
reference starts from it, and a commit needs a majority of the voters
(of both halves in a joint configuration).
"""

from __future__ import annotations

from collections import namedtuple

import torch

from .reference import confchange as C
from .reference import raft_step as R

ROLE_LEADER = R.ROLE_LEADER
# The reference's state with the conf-change protocol's fields beside it:
# what the control carries, and what the check compares in traffic with
# conf changes.
FullState = namedtuple("FullState", R.FIELDS + C.FIELDS)


def ref_config(conf: dict) -> R.Config:
    return R.Config(conf["n_groups"], conf["n_peers"], conf["election_tick"],
                    conf["heartbeat_tick"], conf["check_quorum"], conf["pre_vote"])


def membership(conf: dict, device):
    """(voters, learners) bool[P, G]: the configuration's `voters` and
    `learners`, 1-based slots; a slot in neither is empty.  Without either
    key every slot is a voter."""
    P, G = conf["n_peers"], conf["n_groups"]
    if "voters" not in conf and "learners" not in conf:
        return (torch.ones((P, G), dtype=torch.bool, device=device),
                torch.zeros((P, G), dtype=torch.bool, device=device))
    masks = []
    for key in ("voters", "learners"):
        m = torch.zeros((P, G), dtype=torch.bool, device=device)
        for slot in conf.get(key, []):
            if not 1 <= slot <= P:
                raise ValueError(f"{key} names slot {slot}; the slots are 1..{P}")
            m[slot - 1] = True
        masks.append(m)
    if (masks[0] & masks[1]).any():
        raise ValueError("a slot is both a voter and a learner")
    return masks[0], masks[1]


def init_state(rc: R.Config, conf: dict, device) -> R.State:
    """The reference's initial state in the configuration's membership."""
    voters, learners = membership(conf, device)
    return R.init_state(rc, device)._replace(voter_mask=voters, learner_mask=learners)


def as_ref(st) -> R.State:
    """Any state with the reference's field names, as a reference State."""
    return R.State(**{f: getattr(st, f) for f in R.FIELDS})


def full(st: R.State, cc: C.State) -> FullState:
    return FullState(*st, *cc)


def mismatch(a, b, fields=R.FIELDS) -> int:
    """Entries that differ between two states, over every plane of
    `fields` (a plane one state lacks counts whole)."""
    bad = 0
    for f in fields:
        x, y = getattr(a, f, None), getattr(b, f, None)
        if x is None and y is None:
            continue
        if x is None or y is None or x.shape != y.shape:
            bad += (x if x is not None else y).numel()
            continue
        bad += int((x != y).sum())
    return bad


def run_reference(rc: R.Config, st, crashed, append, rounds: int, step=R.step):
    """`rounds` rounds of `step` (the reference's round by default) from `st`."""
    st = as_ref(st)
    for _ in range(rounds):
        st = step(rc, st, crashed, append)
    return st


def run_arm(rc: R.Config, st, crashed, append, rounds: int, req, arm=None) -> FullState:
    """A block of traffic with conf changes: the request's chains start,
    then `rounds` rounds of the conf-change arm (`arm`, the reference's by
    default) from `st`'s planes and protocol fields."""
    arm = C.Arm() if arm is None else arm
    return full(*arm.run(rc, as_ref(st), C.of(st), crashed, append, rounds, req))


def control_step(rc: R.Config, st: R.State, crashed, append, lead=None) -> R.State:
    """The control: the reference round with replication elided.  Every
    peer that ends the round as a follower keeps its log (last index,
    last term and agreement rows as they were), while each leader keeps
    the commit it computed from its followers' acks: a write committed
    without a majority holding it."""
    out = R.step(rc, st, crashed, append, lead=lead)
    f = out.state != ROLE_LEADER
    pair = f[:, None, :] | f[None, :, :]
    return out._replace(
        last_index=torch.where(f, st.last_index, out.last_index),
        last_term=torch.where(f, st.last_term, out.last_term),
        agree=torch.where(pair, st.agree, out.agree),
    )


def settled(st, crashed) -> bool:
    """Every group has one alive leader and every alive member (a voter,
    outgoing voter or learner) is at its term: the control's stand-in for
    the program's steady predicate."""
    alive = ~crashed & (st.voter_mask | st.outgoing_mask | st.learner_mask)
    lead = (st.state == ROLE_LEADER) & alive
    lead_term = torch.where(lead, st.term, -1).amax(0)
    same = torch.where(alive, st.term == lead_term[None, :], True).all(0)
    return bool(((lead.sum(0) == 1) & same).all())


def guarantee_violations(post, pre=None, strict=None) -> int:
    """Entries where `post` breaks a guarantee every configuration states:
    a commit held by less than a majority of the voters, and in a joint
    configuration by less than a majority of the outgoing voters too
    (raft-rs's JointConfig::committed_index; learners and empty slots never
    count; peer q holds peer p's commit c when agree[p, q] >= c, and
    agree[p, p] is p's own log); two leaders of one group at one term, a
    commit beyond the peer's own log, and, against `pre`, a commit that
    went back.

    `strict` (bool[G], or None for every group) marks the groups held to
    the majority rule.  A conf change may leave an earlier commit short of
    the new majority until the next commit (a new voter still catching up;
    raft-rs commits under the old configuration and applies after), so
    the other groups are held to what that rule keeps safe: no set of
    peers that could elect a leader (a majority of the voters, of both
    halves in a joint configuration) lacks the commit."""
    P = post.commit.shape[0]
    holds = post.agree >= post.commit[:, None, :]  # [p, q, G]: q holds p's commit

    def held(mask):  # (holders of each peer's commit in `mask`, the mask's size)
        return (holds & mask[None, :, :]).sum(1), mask.sum(0)[None, :]

    (hv, nv), (ho, no) = held(post.voter_mask), held(post.outgoing_mask)
    joint = no > 0
    lacking = (hv < R.majority_of(nv)) | (joint & (ho < R.majority_of(no)))
    if strict is not None:
        electable = nv - hv >= R.majority_of(nv)
        electable &= ~joint | (no - ho >= R.majority_of(no))
        lacking = torch.where(strict[None, :], lacking, electable)
    no_majority = (post.commit > 0) & lacking
    bad = int(no_majority.sum()) + int((post.commit > post.last_index).sum())
    lead = post.state == ROLE_LEADER
    for p in range(P):
        for q in range(p + 1, P):
            bad += int((lead[p] & lead[q] & (post.term[p] == post.term[q])).sum())
    if pre is not None:
        bad += int((post.commit < pre.commit).sum())
    return bad


def entries_gap(start, end, expected: torch.Tensor) -> int:
    """For a window without faults: entries (member, group) whose log did
    not grow by exactly the appends the window proposed (`expected`,
    int64[G]) or whose commit is not its last index at the window's end.
    A member is a voter or learner; an empty slot, which no leader
    replicates to, is not one (without a stated membership every slot is
    a voter)."""
    member = end.voter_mask | end.outgoing_mask | end.learner_mask
    grew = end.last_index.to(torch.int64) - start.last_index.to(torch.int64)
    return (int((member & (grew != expected[None, :])).sum())
            + int((member & (end.commit != end.last_index)).sum()))


def entries_gap_members(start, end, expected: torch.Tensor) -> int:
    """For a window without faults in traffic with conf changes: entries
    (member, group) of the groups that elected no leader in the window
    (the highest term unchanged) whose log is not the start's leader log
    grown by exactly `expected` (int64[G]: the appends and the conf
    entries), or whose commit is not its last index.  A member is a voter,
    outgoing voter or learner at the window's end; a group that elected a
    leader dropped the appends of its leaderless rounds and logged a noop,
    which the traffic cannot count."""
    calm = end.term.amax(0) == start.term.amax(0)
    member = (end.voter_mask | end.outgoing_mask | end.learner_mask) & calm[None, :]
    base = start.last_index.to(torch.int64).amax(0)
    off = end.last_index.to(torch.int64) != (base + expected)[None, :]
    return int((member & off).sum()) + int((member & (end.commit != end.last_index)).sum())


def block_check(rc: R.Config, pre, post, crashed, append, rounds: int,
                confchanges=None, with_cc: bool = False) -> tuple:
    """(mismatching entries, guarantee violations) of one block.  In traffic
    with conf changes (`with_cc`) the reference runs its conf-change arm
    from the block's request and compares the protocol's fields too."""
    if with_cc:
        ref = run_arm(rc, pre, crashed, append, rounds, confchanges)
        bad = mismatch(ref, post) + mismatch(ref, post, C.FIELDS)
    else:
        bad = mismatch(run_reference(rc, pre, crashed, append, rounds), post)
    return bad, guarantee_violations(post, pre, made_under_masks(pre, post) if with_cc else None)


def made_under_masks(pre, post) -> torch.Tensor:
    """bool[G]: groups whose masks held still from `pre` to `post` and that
    committed in between, so that their highest commit, and every commit
    below it, was made under `post`'s masks."""
    same = ((pre.voter_mask == post.voter_mask) & (pre.outgoing_mask == post.outgoing_mask)
            & (pre.learner_mask == post.learner_mask)).all(0)
    return same & (post.commit.amax(0) > pre.commit.amax(0))


def settle_check(rc: R.Config, settled_state, appends: torch.Tensor, rounds: int,
                 device, conf: dict) -> int:
    """The start: the reference settles from its own initial state, in the
    configuration's membership, over the same rounds and appends, and must
    reach the program's settled state."""
    crashed = torch.zeros((rc.n_peers, rc.n_groups), dtype=torch.bool, device=device)
    ref = run_reference(rc, init_state(rc, conf, device), crashed, appends, rounds)
    return mismatch(ref, settled_state)

