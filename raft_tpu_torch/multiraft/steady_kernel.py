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
and P = 8..12 those of csrc/steady_round_wide.cu, a library a P.

From P = WARP_PEERS (13) on, the kernel is csrc/steady_round_warp.cu
(csrc/steady_warp_body.cuh), one library for every P, with no cap but the
card's shared memory: one group across half a warp's lanes up to P = 16
(the body's kHalfWarpPeers) and across a warp's 32 past it, J = ceil(P / lanes) peers
a lane (in registers up to P = 128, in the block's shared-memory tile past
it), the planes copied through that tile 256 threads' groups at a time so
every row read and write is a whole sector, the per-round sums and any-of
tests as warp collectives or closed forms, and the majority index as an
exact selection instead of the network: with one acting leader (every
group of a fused block) two order statistics selected once a call give
every round's index in closed form.  A settled round is then the per-peer
updates and one vote, so the instance is bound by the integer ALU: its
bound is `steady_wide_body_work`, the operations of its source counted on
the group's P peers; it does different work from the reference's round (`steady_work`, the
network's count), so a time is held against both.  The switch at 13 is the
narrowest P where the warp instance ran faster than the thread-a-group one
on an H100 (PERF.md, section 6).

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
# From this P the kernel is the warp instance (csrc/steady_round_warp.cu).
WARP_PEERS = _build.STEADY_WARP_PEERS

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


def check_peers(lib, P: int) -> None:
    """Raise ValueError for a P that the library `lib` (load_steady_cuda's
    or a host build holding the warp body) cannot take: below 1, or so wide
    that one group's tile does not fit a block's shared memory (P > 8,015),
    as its steady_warp_block_groups says."""
    if P < 1:
        raise ValueError(f"steady_rounds: P={P} < 1")
    if P >= WARP_PEERS and lib.steady_warp_block_groups(P) == 0:
        raise ValueError(
            f"steady_rounds: P={P}: one group's tile does not fit a block's "
            "shared memory"
        )


def warp_selections(state, voter, member, crashed, acting_row) -> Tuple[int, int]:
    """(selections, radix steps) the warp body's selections take on these
    operands (steady_rounds' planes): in each group with one acting leader,
    the order statistics of the values a sent round leaves fixed (position
    qpos - m where qpos >= m, position qpos where the fixed part has one),
    each as many steps as the bit length of its least and largest biased
    value's XOR."""
    voter, member, crashed = voter != 0, member != 0, crashed != 0
    lead = (state == ROLE_LEADER) & ~crashed
    written = lead | (member & ~crashed)
    fixed = ~(voter & written)
    vals = torch.where(voter, acting_row, 0).to(torch.int64) + 2**31
    lo = torch.where(fixed, vals, 2**32).amin(0)
    hi = torch.where(fixed, vals, -1).amax(0)
    bits = torch.where(hi > lo, torch.frexp((lo ^ hi).to(torch.float64))[1], 0)
    m = (voter & written).sum(0)
    qpos = voter.sum(0) // 2
    n_sel = (qpos >= m).to(torch.int64) + (qpos < fixed.sum(0)).to(torch.int64)
    n_sel = torch.where(lead.sum(0) == 1, n_sel, 0)
    return int(n_sel.sum()), int((n_sel * bits.to(torch.int64)).sum())


def steady_wide_body_work(
    P: int, G: int, rounds: int, with_health: bool = False,
    selections: Tuple[int, int] = (0, 0),
) -> Tuple[int, int]:
    """(bytes, integer operations) of one call of the warp instance
    (csrc/steady_warp_body.cuh) on G groups of P peers that each have one
    acting leader, every round sending (a settled horizon), with
    `selections` = (selections, radix steps) over all groups
    (warp_selections).  `steady_work` counts the reference's round, which
    sorts every round; this is the smaller count of what the body does.

    Bytes: `steady_work`'s (each operand read once, each output written
    once).

    Operations, read off the body's source, one for each add, compare,
    select, min/max, bit operation and flag test, a warp collective one
    for each of the P slots it combines, counted on the group's P peers
    (not on the lanes' padded slots); the tile copies' moves and index
    arithmetic and the loops' control are left out.  Per group and round:
      tick             5P (the election timer) + 4 (the leader's
                       heartbeat) + P (the lead-beat vote)
      append, sent     5
      sync             7 (P - 1) at the members, 4 at the leader
      majority index   4 (the closed form); commit 4; its writes 2P
    and per group once: the flag byte 14P, the five counts and three
    leader sums 16P + 4.  A selection adds 9P + 10 (its values, least and
    largest) and each of its radix steps 2P + 4.  The with_health variant
    adds 5 a round and 6P once, and health_work's bytes.
    """
    per_round = 15 * P + 14 + (5 if with_health else 0)
    per_call = 30 * P + 4 + (6 * P if with_health else 0)
    n_sel, steps = selections
    ops = (per_round * rounds + per_call) * G + (9 * P + 10) * n_sel + (2 * P + 4) * steps
    nbytes = steady_work(P, G, rounds, with_health)[0]
    return nbytes, ops


def launch(
    lib, state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, tsc=None, *, rounds: int, election_tick: int, heartbeat_tick: int,
) -> Outputs:
    """steady_rounds' launch on the card through `lib`, a library that
    holds P's instance: load_steady_cuda(P)'s, or load_steady_warp_cuda()'s
    at any P."""
    P, G = state.shape
    check_peers(lib, P)
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
        return launch(_build.load_steady_cuda(state.shape[0]), *args, **kw)
    if any(t is not None and t.is_cuda for t in args):
        raise ValueError("steady_rounds: tensors on mixed devices")
    return steady_rounds_reference(*args, **kw)


steady_rounds.launches = 0
steady_rounds.health_launches = 0
