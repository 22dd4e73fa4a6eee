"""k fused loss-gated steady rounds: the hand-written CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces `raft_tpu/multiraft/pallas_step.py:_steady_chaos_kernel`, both
variants (built by `_build_chaos_round` at :752), with its helpers `_kernel_loss_draw` (:243), `_agree_event` (:259) and
`_quorum_tile` (:278).  It computes k rounds of `sim.step(link=healed &
~link_loss_draw(round))` for groups in the steady state: each round draws
the per-link loss sample keyed (round, src, dst, group), delivers the
leader's heartbeat over the surviving forward links (and resumes a paused
Progress over the reverse link), sends catch-up appends to lagging
members, commits at stage A off the fresh acks, re-broadcasts a commit
advance, commits at stage B and propagates it, then runs the round's
append workload; the pairwise `agree` block follows every wholesale
adoption.  The with_health variant (`tsc` given) also carries
ticks_since_commit, as the steady kernel's does (steady_kernel.py's
CommitTracker).

Bound on an H100, first by what the outputs need (`chaos_work`: the loss
draws and `loss_rate` entries of the leader's 2(P - 1) links only, and the
plain version's elementwise work): one call must read 8 int32 and 3
one-byte [P, G] planes, the int32 [P, P, G] `agree` plane, the leader's
row and column of `loss_rate` and 3 int32 [G] rows, and write 8 int32
[P, G] planes and `agree`: 57.9 MB at P=5, G=100k, or 17 us at 3.35 TB/s.
The integer work per group and round (8 loss draws, three [P, P]
agreement events with four read-backs of the leader's row, the odd-even
quorum network three times) is far larger, 1,289 operations at P=5, 4.1 G
a call at k=32, or 246 us at the card's 16.75 T/s INT32 rate, so
operations set the bound.  The CUDA body needs less than that
(`chaos_body_work`: 729 operations a group-round at P=5 on a settled
horizon, 140 us a call at k=32), and that smaller count is the kernel's
bound.
The design (csrc/chaos_body.cuh, csrc/chaos_round.cu): one thread per
group holds its P-column of every int32 plane, and its per-peer flags
(the masks and each round's delivery and wave sets) as bit masks, in
registers for all k rounds, P and with_health template parameters so
every peer loop unrolls; loads and stores are peer-major, so neighbouring
threads touch neighbouring words.  Every agreement event of a steady
horizon holds all acting leaders whenever its set is not empty, so the
leaders' summed row, the one the reference reads back from the block, is
carried in registers and the rounds only write the [P, P] `agree` block:
in registers up to P = 13, in the thread's own column of the block's
shared memory past it (each the faster on the card).  Only the links
with an acting leader at one end are drawn (with one leader, as in every
fused block, its 2(P - 1) links, their rates loaded once; with several,
each one's row and column from the plane), which gives the reference's
bits since a draw is a pure function of (round, src, dst, group, rate);
the `loss_rate` block is never held.  128 threads a block and a register
cap give 16 warps an SM at P <= 5.  The loss PRNG runs in native uint32, which wraps as the
reference's does; the group id that keys it is the global thread index
plus `group_base`, the first global id of a mesh rank's block.
`chaos_round_occupancy` in the library reports each instance's
registers, spills, shared memory and resident blocks.  P = 8..15 build
from csrc/chaos_round_wide.cu, one library a P.

On CPU tensors `chaos_rounds` runs `chaos_rounds_reference`; on CUDA
tensors it launches the kernel or raises.  `chaos_rounds.launches` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .kernels import ROLE_FOLLOWER, ROLE_LEADER, link_loss_draw
from .platform import check_operands
from .sim import _merge_agree, _quorum_pick
from .steady_kernel import CommitTracker, health_work

I32 = torch.int32
# The largest P of the chaos and damped kernels: the reference's builders
# assert P <= 15, as its packed roles word budgets 4 bits for leader_id
# (pallas_step.py:772, :1203).
MAX_PEERS = 15

Outputs = Tuple[torch.Tensor, ...]
OUTPUT_NAMES = (
    "state", "leader_id", "hb", "ee", "li", "lt", "commit", "matched_row",
    "agree",
)


def chaos_rounds_reference(
    state, leader_id, hb, ee, li, lt, commit, matched_row, voter, member,
    crashed, agree, loss_rate, ts, lead_term, app, tsc=None, *,
    round_base: int, rounds: int, election_tick: int, heartbeat_tick: int,
    group_base: int = 0,
) -> Outputs:
    """Plain PyTorch version of the kernel.  Planes [P, G] int32 (masks bool
    or 0/1 ints), agree and loss_rate [P, P, G] int32, ts, lead_term and
    app [G] int32, and for the with_health variant tsc, the int32 [G]
    ticks_since_commit row; round_base is the absolute index of the first
    round and group_base the global id of the first group (the loss draw's
    group key).  Returns fresh (state, leader_id, hb, ee, li, lt, commit,
    matched_row, agree), and tsc' last when tsc is given."""
    P, G = state.shape
    dev = state.device
    gids = group_ids(group_base, G, dev)
    voter, member, crashed = voter != 0, member != 0, crashed != 0
    alive = ~crashed
    role_leader = state == ROLE_LEADER
    # Fixed for the whole horizon: the kernel's own writes to `state` never
    # make or unmake the acting leader.
    is_lead = role_leader & alive
    has_leader = is_lead.any(0)
    lead_f = is_lead.to(I32)
    p1 = torch.arange(1, P + 1, dtype=I32, device=dev)[:, None]
    lead_id_val = (lead_f * p1).sum(0, dtype=I32)
    count = voter.sum(0, dtype=I32)
    qpos = count // 2
    n_app = torch.where(has_leader, app, 0)
    track = CommitTracker(tsc, commit)

    def lead_gather(plane):  # [P, G] -> [G]: the acting leader's value
        return (plane * lead_f).sum(0, dtype=I32)

    def lead_row(agree):  # [P, P, G] -> [P, G]: agree[leader, :]
        return (agree * lead_f[:, None, :]).sum(0, dtype=I32)

    for r in range(rounds):
        drop = link_loss_draw(round_base + r, loss_rate, group_ids=gids)
        # Forward (leader -> v) and reverse (v -> leader) delivery.
        dfl = (drop & is_lead[:, None, :]).any(0)
        dtl = (drop & is_lead[None, :, :]).any(1)
        fwd = ~dfl & alive & ~is_lead
        rev = ~dtl & alive & ~is_lead

        # Tick, as the plain steady kernel.
        ee = ee + 1
        ee = torch.where(role_leader & (ee >= election_tick), 0, ee)
        hb = torch.where(role_leader, hb + 1, hb)
        want_beat = role_leader & (hb >= heartbeat_tick)
        hb = torch.where(want_beat, 0, hb)
        beat = (want_beat & is_lead).any(0)

        # Round-start snapshots of the leader's cursors.
        c_l = lead_gather(commit)
        li_l = lead_gather(li)
        lt_l = lead_gather(lt)

        # Wave 1: heartbeat delivery and the reverse-link response.
        h_acc = fwd & beat & member
        state = torch.where(h_acc, ROLE_FOLLOWER, state)
        leader_id = torch.where(h_acc, lead_id_val, leader_id)
        ee = torch.where(h_acc, 0, ee)
        hb_val = torch.minimum(matched_row, c_l)
        commit = torch.where(h_acc, torch.maximum(commit, hb_val), commit)
        resumed = h_acc & rev

        # Pass 1: heartbeat-triggered catch-up appends for lagging members.
        cu = resumed & (matched_row < li_l)
        commit = torch.where(cu, torch.maximum(commit, c_l), commit)
        matched_row = torch.where(cu, torch.maximum(matched_row, li_l), matched_row)
        li = torch.where(cu, li_l, li)
        lt = torch.where(cu, lt_l, lt)
        sent1 = cu.any(0)
        agree = _merge_agree(agree, cu | (is_lead & sent1), li_l, lead_row(agree))

        # Stage-A quorum commit at the leader off the fresh acks.
        mci = _quorum_pick(matched_row, voter, qpos)
        ok_a = has_leader & (count > 0) & (mci >= ts)
        c_new = torch.where(ok_a, torch.maximum(c_l, mci), c_l)
        adv = c_new > c_l
        commit = torch.where(is_lead, c_new, commit)

        # Pass 2: a commit advance re-broadcasts to sendable members.
        agree_l = lead_row(agree)
        sendable = (matched_row > 0) | resumed
        msg2 = fwd & member & adv & sendable
        adopt2 = msg2 & ((agree_l >= li_l) | rev)
        state = torch.where(msg2, ROLE_FOLLOWER, state)
        leader_id = torch.where(msg2, lead_id_val, leader_id)
        ee = torch.where(msg2, 0, ee)
        li = torch.where(adopt2, li_l, li)
        lt = torch.where(adopt2, lt_l, lt)
        matched_row = torch.where(
            adopt2 & rev, torch.maximum(matched_row, li_l), matched_row
        )
        agree = _merge_agree(
            agree, adopt2 | (is_lead & adopt2.any(0)), li_l, agree_l
        )

        # Stage-B commit and the post-advance commit propagation.
        mci2 = _quorum_pick(matched_row, voter, qpos)
        ok_b = has_leader & (count > 0) & (mci2 >= ts)
        c_new2 = torch.where(ok_b, torch.maximum(c_new, mci2), c_new)
        commit = torch.where(is_lead, c_new2, commit)
        agree_l2 = lead_row(agree)
        sendable2 = (matched_row > 0) | resumed
        elig = (
            fwd & member & sendable2 & ((agree_l2 >= li_l) | rev) & (c_new2 > c_l)
        )
        commit = torch.where(elig, torch.maximum(commit, c_new2), commit)

        # The round's append workload at the leader.
        sent_b = has_leader & (n_app > 0)
        li = li + torch.where(is_lead, n_app, 0)
        lt = torch.where(is_lead & sent_b, lead_term, lt)
        lead_last = li_l + n_app
        pr_ok = (matched_row > 0) | resumed
        sync_msg = sent_b & fwd & member & ~is_lead & pr_ok
        agree_l3 = lead_row(agree)
        sync_b = sync_msg & ((agree_l3 >= li_l) | rev)
        state = torch.where(sync_msg, ROLE_FOLLOWER, state)
        leader_id = torch.where(sync_msg, lead_id_val, leader_id)
        ee = torch.where(sync_msg, 0, ee)
        li = torch.where(sync_b, lead_last, li)
        lt = torch.where(sync_b, lead_term, lt)
        acked = (sync_b & rev) | (is_lead & sent_b)
        matched_row = torch.where(
            acked, torch.maximum(matched_row, lead_last), matched_row
        )
        agree = _merge_agree(agree, sync_b | (is_lead & sent_b), lead_last, agree_l3)
        mci3 = _quorum_pick(matched_row, voter, qpos)
        ok_c = sent_b & (count > 0) & (mci3 >= ts)
        lead_commit = torch.where(ok_c, torch.maximum(c_new2, mci3), c_new2)
        commit = torch.where(is_lead, lead_commit, commit)
        commit = torch.where(sync_b, torch.maximum(commit, lead_commit), commit)
        track.round(commit)
    return (
        state, leader_id, hb, ee, li, lt, commit, matched_row, agree
    ) + track.outputs()


def chaos_work(
    P: int, G: int, rounds: int, with_health: bool = False
) -> Tuple[int, int]:
    """(bytes, integer operations) the function needs for G groups that
    each have one acting leader, as every group of a fused block has.

    The outputs read the loss draw only on the leader's links, drop[lead,
    v] and drop[v, lead], so the count takes 2(P - 1) draws a round and
    the leader's row and column of `loss_rate`, not the P² that the plain
    version and the kernel draw and load.

    Bytes: each needed operand read once and each output written once,
    with one-byte masks: 8 int32 and 3 one-byte [P, G] planes, `agree`
    [P, P, G], 2(P - 1) int32 `loss_rate` entries a group and 3 int32 [G]
    rows in; 8 int32 [P, G] planes and `agree` out.

    Operations: the plain version's elementwise operations per group and
    round, read off its code, with an op on a [P, G] plane counting P, on
    a [P, P, G] plane P², a reduction over P rows one per element, and the
    loss PRNG in native 32-bit words as the reference computes it:
      loss draw        10 (key multiply-add, one murmur3 mix) + 12 for each
                       of the 2(P - 1) leader links (lane multiply, xor,
                       mix, modulo, compare)
      delivery         4P (the leader's row and column picked out) + 8P
                       (fwd, rev)
      tick             11P;  leader snapshots 6P (three gathers)
      wave 1           9P;   pass 1 9P;  pass 2 16P
      agreement        20P² + 7P (three events, four leader-row gathers)
      quorum picks     3 × (3P + 2 per comparator of the network)
      commits          7 + P (stage A), 7 + 11P (stage B and propagation)
      workload         9 + 29P
    The with_health variant adds health_work's bytes and operations.
    """
    links = 2 * (P - 1)
    nbytes = (
        (8 * 4 + 3) * P * G + 4 * P * P * G + 4 * links * G + 3 * 4 * G  # in
        + 8 * 4 * P * G + 4 * P * P * G  # out
    )
    comparators = sum(len(range(s % 2, P - 1, 2)) for s in range(P))
    per_round = 20 * P * P + 120 * P + 12 * links + 6 * comparators + 33
    ops = per_round * rounds * G
    if with_health:
        hb, hops = health_work(P, G, rounds)
        nbytes, ops = nbytes + hb, ops + hops
    return nbytes, ops


def chaos_body_work(
    P: int, G: int, rounds: int, with_health: bool = False
) -> Tuple[int, int]:
    """(bytes, integer operations) of the CUDA body (csrc/chaos_body.cuh)
    for G groups that each have one acting leader, on a settled horizon:
    appends every round, so the workload's agreement event holds the
    leader, while the catch-up and pass-2 events are empty and pass 2 is
    skipped (stage A advances nothing).  `chaos_work` counts the plain
    version's work, which the body does not all need (it carries the
    leader's row instead of reading it back from the block, and skips
    empty events), so this count is the smaller; a round that runs more
    events only adds to it.

    Bytes: `chaos_work`'s (the body reads and writes just those).

    Operations: per group and round, read off the body's code by
    `damped_body_work`'s rules, each add, compare, select, min/max and bit
    operation one, a set operation on a peer mask one:
      delivery         12 (the round key, the masks) + 15 for each of the
                       2(P - 1) leader links (the draw as chaos_work counts
                       it, 12; the slot and the bit)
      tick             13P;  leader snapshots 4P
      wave 1, pass 1   18P + 5 (with the empty event's guard)
      stage A          2P + 7;  pass 2 skipped, 3
      stage B and the workload  33P + 9
      quorum picks     3 × (4P + 2 per comparator of the network)
      agreement        the workload's event, 2P² + 4P + 3
      the workload's commit  5P + 5
    and per group once: the loads' masks, the leader and its summed row,
    P² + 20P, and the leader's link slots, P - 1.  The with_health variant
    adds health_work's bytes and operations.
    """
    nbytes, _ = chaos_work(P, G, rounds, with_health)
    comparators = sum(len(range(s % 2, P - 1, 2)) for s in range(P))
    per_round = 2 * P * P + 91 * P + 12 + 15 * 2 * (P - 1) + 6 * comparators + 32
    per_call = P * P + 20 * P + P - 1
    ops = (per_round * rounds + per_call) * G
    if with_health:
        ops += health_work(P, G, rounds)[1]
    return nbytes, ops


def check_group_base(group_base: int) -> None:
    """Raise ValueError unless group_base is a nonnegative int64."""
    if not 0 <= group_base < 2**63:
        raise ValueError(f"group_base {group_base} outside 0..2**63 - 1")


def group_ids(group_base: int, G: int, device) -> Optional[torch.Tensor]:
    """The global ids group_base .. group_base + G - 1 as int64[G] for the
    plain versions' link_loss_draw(group_ids=), or None at base 0 (the
    iota)."""
    if group_base == 0:
        return None
    return torch.arange(group_base, group_base + G, dtype=torch.int64, device=device)


def check_round_base(round_base: int, rounds: int) -> None:
    """Raise ValueError unless every round index round_base + r, r <
    rounds, lies in int32 (the reference's int32 round counter)."""
    if not (-(2**31) <= round_base and round_base + rounds - 1 < 2**31):
        raise ValueError(
            f"round indices {round_base}..{round_base + rounds - 1} leave int32"
        )


def _launch(
    state, leader_id, hb, ee, li, lt, commit, matched_row, voter, member,
    crashed, agree, loss_rate, ts, lead_term, app, tsc, round_base: int,
    rounds: int, election_tick: int, heartbeat_tick: int, group_base: int,
) -> Outputs:
    P, G = state.shape
    if not 1 <= P <= MAX_PEERS:
        raise ValueError(f"chaos_rounds: P={P} outside 1..{MAX_PEERS}")
    dev = state.device
    planes = dict(state=state, leader_id=leader_id, hb=hb, ee=ee, li=li,
                  lt=lt, commit=commit, matched_row=matched_row)
    masks = dict(voter=voter, member=member, crashed=crashed)
    pairs = dict(agree=agree, loss_rate=loss_rate)
    rows = dict(ts=ts, lead_term=lead_term, app=app)
    if tsc is not None:
        rows["tsc"] = tsc
    check_operands("chaos_rounds", dev, (
        (planes, (P, G), I32), (masks, (P, G), torch.bool),
        (pairs, (P, P, G), I32), (rows, (G,), I32),
    ))
    outs = tuple(torch.empty((P, G), dtype=I32, device=dev) for _ in range(8))
    outs += (torch.empty((P, P, G), dtype=I32, device=dev),)
    tsc_out = None if tsc is None else torch.empty((G,), dtype=I32, device=dev)
    lib = _build.load_chaos_cuda(P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [t.data_ptr() for t in (*planes.values(), *masks.values(),
                                       *pairs.values(), ts, lead_term, app,
                                       *outs)]
        args += [None if t is None else t.data_ptr() for t in (tsc, tsc_out)]
        rc = lib.chaos_round_launch(
            *args, G, P, round_base, rounds, election_tick, heartbeat_tick,
            int(tsc is not None), group_base, stream,
        )
    if rc != 0:
        raise RuntimeError(f"chaos_round_launch failed: CUDA error {rc}")
    if tsc is None:
        chaos_rounds.launches += 1
    else:
        chaos_rounds.health_launches += 1
    return outs + (() if tsc_out is None else (tsc_out,))


def chaos_rounds(
    state, leader_id, hb, ee, li, lt, commit, matched_row, voter, member,
    crashed, agree, loss_rate, ts, lead_term, app, tsc=None, *,
    round_base: int, rounds: int, election_tick: int, heartbeat_tick: int,
    group_base: int = 0,
) -> Outputs:
    """`rounds` fused loss-gated steady rounds from absolute round
    `round_base` (every round index must lie in int32), for the groups
    whose global ids start at `group_base` (the loss draw's group key: a
    rank's block of a mesh run passes its first id); returns (state,
    leader_id, hb, ee, li, lt, commit, matched_row, agree), and with `tsc`
    (the with_health variant) the updated ticks_since_commit row last.
    Planes [P, G] int32, masks [P, G] bool, agree and loss_rate [P, P, G]
    int32, ts, lead_term, app and tsc [G] int32.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors run the
    plain version.  `chaos_rounds.launches` counts launches of the
    with_health=False variant, `chaos_rounds.health_launches` those of the
    with_health=True one."""
    check_round_base(round_base, rounds)
    check_group_base(group_base)
    args = (state, leader_id, hb, ee, li, lt, commit, matched_row, voter,
            member, crashed, agree, loss_rate, ts, lead_term, app, tsc)
    kw = dict(round_base=round_base, rounds=rounds, election_tick=election_tick,
              heartbeat_tick=heartbeat_tick, group_base=group_base)
    if state.is_cuda:
        return _launch(*args, **kw)
    if any(t is not None and t.is_cuda for t in args):
        raise ValueError("chaos_rounds: tensors on mixed devices")
    return chaos_rounds_reference(*args, **kw)


chaos_rounds.launches = 0
chaos_rounds.health_launches = 0
