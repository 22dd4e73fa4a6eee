"""k fused check-quorum/pre-vote steady rounds: the hand-written CUDA kernel,
its plain PyTorch version, and the wrapper that picks between them by
device.

Replaces `raft_tpu/multiraft/pallas_step.py:_steady_damped_kernel`, every
variant (built by `_build_damped_round` at :1185).  It
computes k rounds of the damped round (`sim._damped_linked_step`) for
groups in the steady state: the tick with the leader's election-timeout
boundary, which with check_quorum (`with_cq`) clears the acting leader's
`recent_active` row to its own bit; heartbeat delivery and the reverse-link
response, which resumes a paused Progress and sets the leader's
`recent_active` bit; catch-up appends under the damped probe rule (a
member never acked since the election probes from the noop, and a probe
that does not match lands through the retry chain after stage A, its ack
one stage later); the stage-A commit, the commit-advance re-broadcast, the
stage-B commit and its propagation; then the round's append workload.
With `with_loss` each round draws the per-link loss sample first, as the
chaos kernel does.  Leases and low-term nudges are dormant on a steady
horizon (no campaigns, uniform terms), so they need no state.  The
with_health variant (`tsc` given) also carries ticks_since_commit, as the
steady kernel's does (steady_kernel.py's CommitTracker).

Bound on an H100, first by the plain version's work (`damped_work`): one
call must read 8 int32 and 4 one-byte [P, G] planes, the int32 [P, P, G]
`agree` plane and 3 int32 [G] rows, and write 8 int32 and 1 one-byte
[P, G] planes and `agree`: 55.7 MB at P=5, G=100k, or 17 us at 3.35 TB/s.
The integer work per group and round (five [P, P] agreement events with
their leader-row gathers, the odd-even quorum network three times, some
140 selects a peer) is 1,542 operations at P=5, 4.9 G a call at k=32, or
295 us at the card's 16.75 T/s INT32 rate, so operations set the bound.
The CUDA body needs less than the plain version does (`damped_body_work`:
739 operations a group-round at P=5 on a settled horizon, 142 us a call at
k=32), and that smaller count is the kernel's bound.
The design (csrc/damped_body.cuh, csrc/damped_round.cu): one thread per
group holds its P-column of every int32 plane, and its per-peer flags
(the masks, `recent_active` and each round's delivery and wave sets) as
bit masks, in registers for all k rounds, P, with_cq, with_loss and
with_health template parameters so every peer loop unrolls and the
untaken arms compile away; loads and stores are peer-major, so
neighbouring threads touch neighbouring words.  Every agreement event of
a steady horizon holds all acting leaders whenever its set is not empty,
so the leaders' summed row, the one the probes read, is carried in
registers and the rounds only write the [P, P] `agree` block: in
registers up to P = 8, in the thread's own column of the block's shared
memory past it (each the faster on the card).  128 threads a block and a
register cap give 16 warps an SM at P <= 5.  With loss only the links
with an acting leader at one end are drawn (with one leader, as in every
fused block, its 2(P - 1) links to the others, their rates loaded once;
with several, each one's row and column from the plane), which gives the
reference's bits since a draw is a pure function of (round, src, dst,
group, rate).  `damped_round_occupancy` in the library reports each
instance's registers, spills, shared memory and resident blocks.
P = 8..15 build from csrc/damped_round_wide.cu, a library of its own.

On CPU tensors `damped_rounds` runs `damped_rounds_reference`; on CUDA
tensors it launches the kernel or raises.  `damped_rounds.launches` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .chaos_kernel import MAX_PEERS, check_group_base, check_round_base, group_ids
from .kernels import ROLE_FOLLOWER, ROLE_LEADER, link_loss_draw
from .platform import check_operands
from .sim import _merge_agree, _quorum_pick
from .steady_kernel import CommitTracker, health_work

I32 = torch.int32

Outputs = Tuple[torch.Tensor, ...]
OUTPUT_NAMES = (
    "state", "leader_id", "hb", "ee", "li", "lt", "commit", "matched_row",
    "ra", "agree",
)


def damped_rounds_reference(
    state, leader_id, hb, ee, li, lt, commit, matched_row, ra, voter, member,
    crashed, agree, loss_rate, ts, lead_term, app, tsc=None, *,
    round_base: int, rounds: int, election_tick: int, heartbeat_tick: int,
    with_cq: bool, group_base: int = 0,
) -> Outputs:
    """Plain PyTorch version of the kernel.  Planes [P, G] int32, the
    acting leader's recent_active row `ra` and the masks bool (or 0/1
    ints), agree [P, P, G] int32, loss_rate [P, P, G] int32 or None (no
    loss), ts, lead_term and app [G] int32, and for the with_health variant
    tsc, the int32 [G] ticks_since_commit row; round_base is the absolute
    index of the first round and group_base the global id of the first
    group (both read only with loss).  Returns fresh (state,
    leader_id, hb, ee, li, lt, commit, matched_row, ra, agree), ra bool,
    and tsc' last when tsc is given."""
    P, G = state.shape
    dev = state.device
    gids = group_ids(group_base, G, dev)
    voter, member, crashed, ra = voter != 0, member != 0, crashed != 0, ra != 0
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
    sent_b = has_leader & (n_app > 0)
    track = CommitTracker(tsc, commit)

    def lead_gather(plane):  # [P, G] -> [G]: the acting leader's value
        return (plane * lead_f).sum(0, dtype=I32)

    def lead_row(agree):  # [P, P, G] -> [P, G]: agree[leader, :]
        return (agree * lead_f[:, None, :]).sum(0, dtype=I32)

    def event(agree, adopted, value):
        """A wholesale adoption from the leader by `adopted`, the leader
        joining the set when anyone adopted."""
        in_set = adopted | (is_lead & adopted.any(0))
        return _merge_agree(agree, in_set, value, lead_row(agree))

    def follow(mask, state, leader_id, ee):
        return (
            torch.where(mask, ROLE_FOLLOWER, state),
            torch.where(mask, lead_id_val, leader_id),
            torch.where(mask, 0, ee),
        )

    def adopt_cursors(mask, value, term, li, lt):
        return torch.where(mask, value, li), torch.where(mask, term, lt)

    for r in range(rounds):
        if loss_rate is not None:
            drop = link_loss_draw(round_base + r, loss_rate, group_ids=gids)
            dfl = (drop & is_lead[:, None, :]).any(0)  # leader -> v dropped
            dtl = (drop & is_lead[None, :, :]).any(1)  # v -> leader dropped
            fwd = ~dfl & alive & ~is_lead
            rev = ~dtl & alive & ~is_lead
        else:
            fwd = alive & ~is_lead
            rev = fwd

        # Tick, with the leader's election-timeout boundary: with
        # check_quorum it clears the acting leader's row to its own bit
        # (the steady predicate proves the read passes).
        ee = ee + 1
        boundary = role_leader & (ee >= election_tick)
        ee = torch.where(boundary, 0, ee)
        if with_cq:
            ra = torch.where((boundary & is_lead).any(0), is_lead, ra)
        hb = torch.where(role_leader, hb + 1, hb)
        want_beat = role_leader & (hb >= heartbeat_tick)
        hb = torch.where(want_beat, 0, hb)
        beat = (want_beat & is_lead).any(0)

        # Round-start snapshots of the leader's cursors.
        c_l = lead_gather(commit)
        li_l = lead_gather(li)
        lt_l = lead_gather(lt)

        # Wave 1: heartbeat delivery; wave 2a: the responses resume probes
        # and set recent_active bits; lagging members get a catch-up.
        h_acc = fwd & beat & member
        state, leader_id, ee = follow(h_acc, state, leader_id, ee)
        commit = torch.where(
            h_acc, torch.maximum(commit, torch.minimum(matched_row, c_l)), commit
        )
        resumed = h_acc & rev
        ra = ra | resumed
        cu = resumed & (matched_row < li_l)

        # Wave 3: catch-up appends under the damped probe rule.
        probe3 = lead_row(agree) >= torch.where(matched_row == 0, ts - 1, li_l)
        adopt3 = cu & probe3
        retry3 = cu & ~probe3  # cu implies the reverse link is up
        commit = torch.where(adopt3, torch.maximum(commit, c_l), commit)
        li, lt = adopt_cursors(adopt3, li_l, lt_l, li, lt)
        agree = event(agree, adopt3, li_l)

        # Wave 4: the probe-matched acks, then the stage-A commit.
        matched_row = torch.where(adopt3, torch.maximum(matched_row, li_l), matched_row)
        ra = ra | adopt3
        mci = _quorum_pick(matched_row, voter, qpos)
        ok_a = has_leader & (count > 0) & (mci >= ts)
        c_new = torch.where(ok_a, torch.maximum(c_l, mci), c_l)
        adv = c_new > c_l
        commit = torch.where(is_lead, c_new, commit)

        # The wave-3 retry resends land after stage A.
        commit = torch.where(retry3, torch.maximum(commit, c_l), commit)
        li, lt = adopt_cursors(retry3, li_l, lt_l, li, lt)
        agree = event(agree, retry3, li_l)

        # Wave 5: the commit-advance re-broadcast, damped probe rule.
        sendable = (matched_row > 0) | resumed
        rb5 = fwd & member & adv & sendable
        probe5 = lead_row(agree) >= torch.where(matched_row == 0, ts - 1, li_l)
        adopt5 = rb5 & probe5
        retry5 = rb5 & ~probe5 & rev
        state, leader_id, ee = follow(rb5, state, leader_id, ee)
        li, lt = adopt_cursors(adopt5, li_l, lt_l, li, lt)
        agree = event(agree, adopt5, li_l)
        li, lt = adopt_cursors(retry5, li_l, lt_l, li, lt)
        agree = event(agree, retry5, li_l)

        # Wave 6: the deferred acks, the stage-B commit and its
        # propagation to sendable members.
        ack5 = (adopt5 & rev) | retry3 | retry5
        matched_row = torch.where(ack5, torch.maximum(matched_row, li_l), matched_row)
        ra = ra | ack5
        mci2 = _quorum_pick(matched_row, voter, qpos)
        ok_b = has_leader & (count > 0) & (mci2 >= ts)
        c_new2 = torch.where(ok_b, torch.maximum(c_new, mci2), c_new)
        commit = torch.where(is_lead, c_new2, commit)
        agree_l = lead_row(agree)
        sendable2 = (matched_row > 0) | resumed
        elig6 = fwd & member & sendable2 & ((agree_l >= li_l) | rev) & (c_new2 > c_l)
        commit = torch.where(elig6, torch.maximum(commit, c_new2), commit)
        ra = ra | (elig6 & rev)

        # The round's append workload at the acting leader.
        li = li + torch.where(is_lead, n_app, 0)
        lt = torch.where(is_lead & sent_b, lead_term, lt)
        lead_last = li_l + n_app
        send_w = sent_b & fwd & member & sendable2
        probe_w = agree_l >= torch.where(matched_row == 0, ts - 1, li_l)
        sync_b = send_w & (probe_w | rev)
        state, leader_id, ee = follow(send_w, state, leader_id, ee)
        li, lt = adopt_cursors(sync_b, lead_last, lead_term, li, lt)
        ack_w = sync_b & rev
        matched_row = torch.where(
            ack_w | (is_lead & sent_b), torch.maximum(matched_row, lead_last),
            matched_row,
        )
        ra = ra | ack_w
        in_set = sync_b | (is_lead & sent_b)
        agree = _merge_agree(agree, in_set, lead_last, agree_l)
        mci3 = _quorum_pick(matched_row, voter, qpos)
        ok_c = sent_b & (count > 0) & (mci3 >= ts)
        lead_commit = torch.where(ok_c, torch.maximum(c_new2, mci3), c_new2)
        commit = torch.where(is_lead, lead_commit, commit)
        commit = torch.where(sync_b, torch.maximum(commit, lead_commit), commit)
        track.round(commit)
    return (
        state, leader_id, hb, ee, li, lt, commit, matched_row, ra, agree
    ) + track.outputs()


def damped_work(
    P: int, G: int, rounds: int, with_cq: bool = True, with_loss: bool = False,
    with_health: bool = False,
) -> Tuple[int, int]:
    """(bytes, integer operations) the function needs for G groups that
    each have one acting leader, as every group of a fused block has.

    Bytes: each needed operand read once and each output written once,
    with one-byte masks: 8 int32 and 4 one-byte (`ra` and the three masks)
    [P, G] planes, `agree` [P, P, G] and 3 int32 [G] rows in, plus with
    loss the leader's 2(P - 1) `loss_rate` entries a group; 8 int32 and one
    one-byte [P, G] planes and `agree` out.

    Operations: the plain version's elementwise operations per group and
    round, read off its code, with an op on a [P, G] plane counting P, on
    a [P, P, G] plane P², and a reduction over P rows one per element:
      delivery         2P without loss; with loss as chaos_work: 10 + 12
                       for each of the 2(P - 1) leader links, 4P + 8P
      tick             11P, with check_quorum 3P more (the row clear)
      leader snapshots 6P (three gathers)
      waves 1 and 2a   12P;  wave 3 10P + 1;  wave 4 3P;  retry3 4P
      wave 5           19P;  wave 6 6P;  propagation 12P + 1
      agreement        5 events × (4P² + 3P) and the leader's row at the
                       5 distinct `agree` states they read, 2P² each
      quorum picks     3 × (3P + 2 per comparator of the network)
      commits          7 + P (stage A), 6 + P (stage B), 6 + 3P (workload)
      workload         25P + 1
    The with_health variant adds health_work's bytes and operations.
    """
    links = 2 * (P - 1)
    nbytes = (
        (8 * 4 + 4) * P * G + 4 * P * P * G + 3 * 4 * G  # in
        + (8 * 4 + 1) * P * G + 4 * P * P * G  # out
    )
    if with_loss:
        nbytes += 4 * links * G
    comparators = sum(len(range(s % 2, P - 1, 2)) for s in range(P))
    per_round = 30 * P * P + 137 * P + 6 * comparators + 22
    per_round += (10 + 12 * links + 12 * P) if with_loss else 2 * P
    if with_cq:
        per_round += 3 * P
    ops = per_round * rounds * G
    if with_health:
        hb, hops = health_work(P, G, rounds)
        nbytes, ops = nbytes + hb, ops + hops
    return nbytes, ops


def damped_body_work(
    P: int, G: int, rounds: int, with_cq: bool = True, with_loss: bool = False,
    with_health: bool = False,
) -> Tuple[int, int]:
    """(bytes, integer operations) of the CUDA body (csrc/damped_body.cuh)
    for G groups that each have one acting leader, on a settled horizon:
    appends every round, so wave 6's agreement event holds the leader,
    while the four adoption events are empty and wave 5 is skipped (stage
    A advances nothing).  `damped_work` counts the plain version's work,
    which the body does not all need (it carries the leader's row instead
    of reading it back from the block, and skips empty events), so this
    count is the smaller; a round that runs more events only adds to it.

    Bytes: `damped_work`'s (the body reads and writes just those).

    Operations: per group and round, read off the body's code, each add,
    compare, select, min/max and bit operation one, a set operation on a
    peer mask one:
      delivery         0 without loss; with loss 12 (the round key, the
                       masks) + 15 for each of the 2(P - 1) leader links
                       (the draw as chaos_work counts it, 12; the slot and
                       the bit)
      tick             15P, with check_quorum 1 more
      leader snapshots 4P
      waves 1 to 3     23P + 7;  wave 4 and the retries 10P + 10;  wave 5 10
      wave 6           44P + 8;  the workload's commit 5P + 5
      quorum picks     3 × (4P + 2 per comparator of the network)
      agreement        wave 6's event, 2P² + 4P + 3
    and per group once: the loads' masks, the leader and its summed row,
    P² + 23P, with loss P - 1 more (the leader's link slots).  The
    with_health variant adds health_work's bytes and operations.
    """
    nbytes, _ = damped_work(P, G, rounds, with_cq, with_loss, with_health)
    comparators = sum(len(range(s % 2, P - 1, 2)) for s in range(P))
    per_round = 2 * P * P + 117 * P + 6 * comparators + 43
    per_call = P * P + 23 * P
    if with_cq:
        per_round += 1
    if with_loss:
        per_round += 12 + 15 * 2 * (P - 1)
        per_call += P - 1
    ops = (per_round * rounds + per_call) * G
    if with_health:
        ops += health_work(P, G, rounds)[1]
    return nbytes, ops


def _launch(
    state, leader_id, hb, ee, li, lt, commit, matched_row, ra, voter, member,
    crashed, agree, loss_rate, ts, lead_term, app, tsc, round_base: int,
    rounds: int, election_tick: int, heartbeat_tick: int, with_cq: bool,
    group_base: int,
) -> Outputs:
    P, G = state.shape
    if not 1 <= P <= MAX_PEERS:
        raise ValueError(f"damped_rounds: P={P} outside 1..{MAX_PEERS}")
    dev = state.device
    planes = dict(state=state, leader_id=leader_id, hb=hb, ee=ee, li=li,
                  lt=lt, commit=commit, matched_row=matched_row)
    masks = dict(ra=ra, voter=voter, member=member, crashed=crashed)
    pairs = dict(agree=agree)
    if loss_rate is not None:
        pairs["loss_rate"] = loss_rate
    rows = dict(ts=ts, lead_term=lead_term, app=app)
    if tsc is not None:
        rows["tsc"] = tsc
    check_operands("damped_rounds", dev, (
        (planes, (P, G), I32), (masks, (P, G), torch.bool),
        (pairs, (P, P, G), I32), (rows, (G,), I32),
    ))
    outs = tuple(torch.empty((P, G), dtype=I32, device=dev) for _ in range(8))
    outs += (torch.empty((P, G), dtype=torch.bool, device=dev),
             torch.empty((P, P, G), dtype=I32, device=dev))
    tsc_out = None if tsc is None else torch.empty((G,), dtype=I32, device=dev)
    lib = _build.load_damped_cuda(P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (*planes.values(), *masks.values(), agree)]
        ptrs.append(None if loss_rate is None else loss_rate.data_ptr())
        ptrs += [t.data_ptr() for t in (ts, lead_term, app, *outs)]
        ptrs += [None if t is None else t.data_ptr() for t in (tsc, tsc_out)]
        rc = lib.damped_round_launch(
            *ptrs, G, P, round_base, rounds, election_tick, heartbeat_tick,
            int(with_cq), int(loss_rate is not None), int(tsc is not None),
            group_base, stream,
        )
    if rc != 0:
        raise RuntimeError(f"damped_round_launch failed: CUDA error {rc}")
    if tsc is None:
        damped_rounds.launches += 1
    else:
        damped_rounds.health_launches += 1
    return outs + (() if tsc_out is None else (tsc_out,))


def damped_rounds(
    state, leader_id, hb, ee, li, lt, commit, matched_row, ra, voter, member,
    crashed, agree, loss_rate: Optional[torch.Tensor], ts, lead_term, app,
    tsc: Optional[torch.Tensor] = None, *, round_base: int, rounds: int,
    election_tick: int, heartbeat_tick: int, with_cq: bool,
    group_base: int = 0,
) -> Outputs:
    """`rounds` fused damped steady rounds; returns (state, leader_id, hb,
    ee, li, lt, commit, matched_row, ra, agree), and with `tsc` (the
    with_health variant) the updated ticks_since_commit row last.  Planes
    [P, G] int32, ra and the masks [P, G] bool, agree [P, P, G] int32,
    loss_rate [P, P, G] int32 or None (no loss: round_base is not read),
    ts, lead_term, app and tsc [G] int32.  With loss, every round index
    round_base + r must lie in int32, and the loss draw keys each group on
    its global id, group_base + g (a rank's block of a mesh run passes its
    first id).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors run the
    plain version.  `damped_rounds.launches` counts launches of the
    with_health=False variants, `damped_rounds.health_launches` those of
    the with_health=True ones."""
    if loss_rate is not None:
        check_round_base(round_base, rounds)
    check_group_base(group_base)
    args = (state, leader_id, hb, ee, li, lt, commit, matched_row, ra, voter,
            member, crashed, agree, loss_rate, ts, lead_term, app, tsc)
    kw = dict(round_base=round_base, rounds=rounds, election_tick=election_tick,
              heartbeat_tick=heartbeat_tick, with_cq=with_cq,
              group_base=group_base)
    if state.is_cuda:
        return _launch(*args, **kw)
    if any(t is not None and t.is_cuda for t in args):
        raise ValueError("damped_rounds: tensors on mixed devices")
    return damped_rounds_reference(*args, **kw)


damped_rounds.launches = 0
damped_rounds.health_launches = 0
