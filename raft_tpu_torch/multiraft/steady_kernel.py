"""k fused steady protocol rounds: the hand-written CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces `raft_tpu/multiraft/pallas_step.py:_steady_kernel`, both
variants (built by `steady_round` at :549).  Over `rounds` rounds, with the
crash mask and the append count held constant, each group's timers tick by
role (the leader heartbeats), the alive leader appends `app` entries, alive
members sync to it (ee -> 0, adopt its log tail, their slots of the acting
matched row follow), and the leader's commit advances to the voters'
majority index once that index reaches the leader's term start.  The
with_health variant (`tsc` given) also carries the group's
ticks_since_commit: 0 after a round whose max commit over all P rows grew,
else one more.

Bound on an H100: the call is one pass over its operands.  With bool masks
as one-byte planes it reads 8 int32 and 3 one-byte [P, G] planes plus two
int32 [G] rows, and writes 6 int32 [P, G] planes: (8·4 + 3 + 6·4)·P·G +
8·G bytes, 30.3 MB at P=5, G=100k, or 9.0 µs at 3.35 TB/s.  The integer
work grows with `rounds` (208 operations per group and round at P=5,
`steady_work`): at k=32 that is 666 M operations, 39.7 µs at the card's
16.75 T/s INT32 rate, so operations set the bound.
The design keeps both low: one thread per group holds its P-column of
every plane in registers for all k rounds (csrc/steady_body.cuh, P a
template parameter so the peer loops and the odd-even network unroll), so
each byte crosses the memory bus once per call, and the peer-major layout
makes neighbouring threads touch neighbouring words.  On the card it is
limited by integer issue: 100k groups give only about 760 threads an SM,
each running a long dependent chain.  The with_health variant is one
template flag (csrc/fused_common.cuh's CommitTracker): P + 2 more
operations a group and round on values already in registers, and the [G]
`tsc` row in and out.  P = 1..7 are the instances of csrc/steady_round.cu
and P = 8..15 those of csrc/steady_round_wide.cu, a library of its own;
for P = 16..MAX_PEERS that library's one runtime-P instance keeps the
per-peer arrays in local memory (the reference's kernel has no bound on
P; the cap sizes those arrays).

On CPU tensors `steady_rounds` runs `steady_rounds_reference`, the same
arithmetic as plain tensor code; on CUDA tensors it launches the kernel or
raises.  `steady_rounds.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .kernels import ROLE_LEADER
from .platform import check_operands
from .sim import _quorum_pick

I32 = torch.int32
# The largest P the kernel takes: csrc/steady_body.cuh's kSteadyCap.
MAX_PEERS = 64

Outputs = Tuple[torch.Tensor, ...]


class CommitTracker:
    """The with_health variants' ticks_since_commit, as plain tensor code
    (csrc/fused_common.cuh's CommitTracker; pallas_step.py:150-152,
    :224-231, :239-240): before round 1 the previous max commit is the max
    over all P rows, crashed rows included; after each round's last commit
    write, tsc is 0 where that max grew, else tsc + 1.  With tsc None it
    tracks nothing."""

    def __init__(self, tsc, commit):
        self.tsc = tsc
        if tsc is not None:
            self.maxc_prev = commit.amax(0)

    def round(self, commit):
        if self.tsc is not None:
            maxc = commit.amax(0)
            self.tsc = torch.where(maxc > self.maxc_prev, 0, self.tsc + 1)
            self.maxc_prev = maxc

    def outputs(self) -> Outputs:
        """(tsc',) for the with_health variant, else ()."""
        return () if self.tsc is None else (self.tsc,)


def health_work(P: int, G: int, rounds: int) -> Tuple[int, int]:
    """(bytes, operations) the with_health variant adds to a call: the
    int32 [G] tsc row read and written once; the max over P rows (P - 1)
    before round 1, and each round the max (P - 1), the compare, the
    increment and the select."""
    return 2 * 4 * G, ((P - 1) + (P + 2) * rounds) * G


def steady_rounds_reference(
    state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, tsc=None, *, rounds: int, election_tick: int,
    heartbeat_tick: int,
) -> Outputs:
    """Plain PyTorch version of the kernel: planes [P, G] (int32; masks
    bool or 0/1 ints), ts and app [G] int32, and for the with_health
    variant tsc, the int32 [G] ticks_since_commit row.  Returns (ee, hb,
    li, lt, acting_row, commit) as fresh int32 [P, G] tensors, and tsc'
    last when tsc is given."""
    voter, member, crashed = voter != 0, member != 0, crashed != 0
    matched = acting_row
    alive = ~crashed
    role_leader = state == ROLE_LEADER
    is_leader = role_leader & alive
    has_leader = is_leader.any(0)  # [G]
    qpos = voter.sum(0, dtype=I32) // 2
    n_app = torch.where(has_leader, app, 0)
    track = CommitTracker(tsc, commit)
    for _ in range(rounds):
        ee = ee + 1
        ee = torch.where(role_leader & (ee >= election_tick), 0, ee)
        hb = torch.where(role_leader, hb + 1, hb)
        want_beat = role_leader & (hb >= heartbeat_tick)
        hb = torch.where(want_beat, 0, hb)

        li = li + torch.where(is_leader, n_app, 0)
        lt = torch.where(is_leader, term, lt)
        lead_last = torch.where(is_leader, li, 0).sum(0, dtype=I32)
        lead_lt = torch.where(is_leader, lt, 0).sum(0, dtype=I32)

        lead_beat = (want_beat & is_leader).any(0)
        sent = has_leader & (lead_beat | (n_app > 0))

        sync = sent & alive & member & ~is_leader
        ee = torch.where(sync, 0, ee)
        li = torch.where(sync, lead_last, li)
        lt = torch.where(sync, lead_lt, lt)
        matched = torch.where(sync | (is_leader & sent), li, matched)

        mci = _quorum_pick(matched, voter, qpos)

        ok = has_leader & sent & (mci >= ts)
        lead_commit_old = torch.where(is_leader, commit, 0).sum(0, dtype=I32)
        lead_commit = torch.where(
            ok, torch.maximum(lead_commit_old, mci), lead_commit_old
        )
        commit = torch.where((is_leader | sync) & sent, lead_commit, commit)
        track.round(commit)
    return (ee, hb, li, lt, matched, commit) + track.outputs()


def steady_work(
    P: int, G: int, rounds: int, with_health: bool = False
) -> Tuple[int, int]:
    """(bytes, integer operations) one call needs: each operand read once
    and each output written once, with one-byte masks; and the elementwise
    operations of the reference's round (9P tick, 7P append, 2P+3 beat,
    10P sync, P masking plus 2 per comparator of the network, 2P for the
    quorum pick, 2P+5 commit, 3P broadcast) times rounds.  The with_health
    variant adds the int32 [G] tsc row in and out and health_work's
    operations."""
    nbytes = (8 * 4 + 3 + 6 * 4) * P * G + 2 * 4 * G
    comparators = sum(len(range(s % 2, P - 1, 2)) for s in range(P))
    per_round = 36 * P + 8 + 2 * comparators
    ops = per_round * rounds * G
    if with_health:
        hb, hops = health_work(P, G, rounds)
        nbytes, ops = nbytes + hb, ops + hops
    return nbytes, ops


def _launch(
    state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, tsc, rounds: int, election_tick: int, heartbeat_tick: int,
) -> Outputs:
    P, G = state.shape
    if not 1 <= P <= MAX_PEERS:
        raise ValueError(f"steady_rounds: P={P} outside 1..{MAX_PEERS}")
    dev = state.device
    planes = dict(state=state, term=term, ee=ee, hb=hb, li=li, lt=lt,
                  acting_row=acting_row, commit=commit)
    masks = dict(voter=voter, member=member, crashed=crashed)
    rows = dict(ts=ts, app=app)
    if tsc is not None:
        rows["tsc"] = tsc
    check_operands("steady_rounds", dev, (
        (planes, (P, G), I32), (masks, (P, G), torch.bool), (rows, (G,), I32)
    ))
    outs = tuple(torch.empty((P, G), dtype=I32, device=dev) for _ in range(6))
    tsc_out = None if tsc is None else torch.empty((G,), dtype=I32, device=dev)
    lib = _build.load_steady_cuda(P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [t.data_ptr() for t in (*planes.values(), *masks.values(), ts,
                                       app, *outs)]
        args += [None if t is None else t.data_ptr() for t in (tsc, tsc_out)]
        rc = lib.steady_round_launch(
            *args, G, P, rounds, election_tick, heartbeat_tick,
            int(tsc is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"steady_round_launch failed: CUDA error {rc}")
    if tsc is None:
        steady_rounds.launches += 1
    else:
        steady_rounds.health_launches += 1
    return outs + (() if tsc_out is None else (tsc_out,))


def steady_rounds(
    state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, tsc=None, *, rounds: int, election_tick: int,
    heartbeat_tick: int,
) -> Outputs:
    """`rounds` fused steady rounds; returns (ee, hb, li, lt, acting_row,
    commit), and with `tsc` (the with_health variant) the updated
    ticks_since_commit row last.  Planes [P, G] int32, masks [P, G] bool,
    ts, app and tsc [G] int32.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors run the
    plain version.  `steady_rounds.launches` counts launches of the
    with_health=False variant, `steady_rounds.health_launches` those of the
    with_health=True one."""
    args = (state, term, ee, hb, li, lt, acting_row, commit, voter, member,
            crashed, ts, app, tsc)
    kw = dict(rounds=rounds, election_tick=election_tick,
              heartbeat_tick=heartbeat_tick)
    if state.is_cuda:
        return _launch(*args, **kw)
    if any(t is not None and t.is_cuda for t in args):
        raise ValueError("steady_rounds: tensors on mixed devices")
    return steady_rounds_reference(*args, **kw)


steady_rounds.launches = 0
steady_rounds.health_launches = 0
