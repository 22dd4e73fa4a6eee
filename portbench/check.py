"""What decides `correct`: the program's states against the plain
reference's, and the configuration's guarantees.

Nothing here imports the program.  A state is read by its field names
(`reference.raft_step.FIELDS`), so the program's states and the
reference's compare plane by plane.

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
"""

from __future__ import annotations

import torch

from .reference import raft_step as R

ROLE_LEADER = R.ROLE_LEADER


def ref_config(conf: dict) -> R.Config:
    return R.Config(conf["n_groups"], conf["n_peers"], conf["election_tick"],
                    conf["heartbeat_tick"], conf["check_quorum"], conf["pre_vote"])


def as_ref(st) -> R.State:
    """Any state with the reference's field names, as a reference State."""
    return R.State(**{f: getattr(st, f) for f in R.FIELDS})


def mismatch(a, b) -> int:
    """Entries that differ between two states, over every plane."""
    bad = 0
    for f in R.FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            continue
        if x is None or y is None or x.shape != y.shape:
            bad += (x if x is not None else y).numel()
            continue
        bad += int((x != y).sum())
    return bad


def run_reference(rc: R.Config, st, crashed, append, rounds: int, control: bool = False):
    """`rounds` reference rounds from `st` (the control's with `control`)."""
    st = as_ref(st)
    step = control_step if control else R.step
    for _ in range(rounds):
        st = step(rc, st, crashed, append)
    return st


def control_step(rc: R.Config, st: R.State, crashed, append) -> R.State:
    """The control: the reference round with replication elided.  Every
    peer that ends the round as a follower keeps its log (last index,
    last term and agreement rows as they were), while each leader keeps
    the commit it computed from its followers' acks: a write committed
    without a majority holding it."""
    out = R.step(rc, st, crashed, append)
    f = out.state != ROLE_LEADER
    pair = f[:, None, :] | f[None, :, :]
    return out._replace(
        last_index=torch.where(f, st.last_index, out.last_index),
        last_term=torch.where(f, st.last_term, out.last_term),
        agree=torch.where(pair, st.agree, out.agree),
    )


def settled(st, crashed) -> bool:
    """Every group has one alive leader and every alive peer is at its
    term: the control's stand-in for the program's steady predicate."""
    alive = ~crashed
    lead = (st.state == ROLE_LEADER) & alive
    lead_term = torch.where(lead, st.term, -1).amax(0)
    same = torch.where(alive, st.term == lead_term[None, :], True).all(0)
    return bool(((lead.sum(0) == 1) & same).all())


def guarantee_violations(post, pre=None) -> int:
    """Entries where `post` breaks a guarantee every configuration states:
    a commit held by less than a majority (peer q holds peer p's commit c
    when agree[p, q] >= c; agree[p, p] is p's own log), two leaders of one
    group at one term, a commit beyond the peer's own log, and, against
    `pre`, a commit that went back."""
    P = post.commit.shape[0]
    held = (post.agree >= post.commit[:, None, :]).sum(1)
    no_majority = (post.commit > 0) & (held < P // 2 + 1)
    bad = int(no_majority.sum()) + int((post.commit > post.last_index).sum())
    lead = post.state == ROLE_LEADER
    for p in range(P):
        for q in range(p + 1, P):
            bad += int((lead[p] & lead[q] & (post.term[p] == post.term[q])).sum())
    if pre is not None:
        bad += int((post.commit < pre.commit).sum())
    return bad


def entries_gap(start, end, expected: torch.Tensor) -> int:
    """For a window without faults: entries (peer, group) whose log did not
    grow by exactly the appends the window proposed (`expected`, int64[G])
    or whose commit is not its last index at the window's end."""
    grew = end.last_index.to(torch.int64) - start.last_index.to(torch.int64)
    return int((grew != expected[None, :]).sum()) + int((end.commit != end.last_index).sum())


def block_check(rc: R.Config, pre, post, crashed, append, rounds: int) -> tuple:
    """(mismatching entries, guarantee violations) of one block."""
    ref = run_reference(rc, pre, crashed, append, rounds)
    return mismatch(ref, post), guarantee_violations(post, pre)


def settle_check(rc: R.Config, settled_state, appends: torch.Tensor, rounds: int,
                 device) -> int:
    """The start: the reference settles from its own initial state over the
    same rounds and appends, and must reach the program's settled state."""
    crashed = torch.zeros((rc.n_peers, rc.n_groups), dtype=torch.bool, device=device)
    ref = run_reference(rc, R.init_state(rc, device), crashed, appends, rounds)
    return mismatch(ref, settled_state)

