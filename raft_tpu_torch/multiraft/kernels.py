"""Elementwise protocol kernels on [P, G] tensors: the subset of
`raft_tpu/multiraft/kernels.py` that the ported steps call.

Counterparts (reference file `raft_tpu/multiraft/kernels.py`):
  INF, VOTE_*          :162-167
  majority_of          :170
  committed_index      :175
  _mix32               :331
  LOSS_SCALE           :342
  link_loss_draw       :345
  pack_bits, unpack_bits, pack_u16_pairs, unpack_u16_pairs  :382-432
  pack_bits_g, unpack_bits_g  :435-470
  SV_*, N_SAFETY, SAFETY_NAMES, check_safety  :471-807
  check_safety_groups  :810-948
  lease_read           :500-604
  apply_confchange     :949-1070
  apply_transfer       :1071-1127
  acting_leader_id     :1128
  check_quorum_active  :1147
  cq_boundary_safe     :1178
  timeout_draw         :1258
  ROLE_*               :1280-1283
  CTR_*, N_COUNTERS, COUNTER_NAMES, zero_counters, count_events  :1294-1336
  HP_*, N_HEALTH_PLANES, HEALTH_PLANE_NAMES, LAG_BUCKET_BOUNDS,
  N_LAG_BUCKETS, HS_*, HEALTH_COUNT_NAMES, zero_health, update_health,
  health_summary       :1349-1461
  BB_*, pack_blackbox_meta, unpack_blackbox_meta, zero_blackbox,
  blackbox_fold, blackbox_mark, blackbox_capture  :1462-1627
  tick_kernel          :1628

The reference computes the timeout and loss PRNGs in uint32.  PyTorch's uint32
tensors do not support `>>`, `+`, `%` or `<` on every backend, so here the
words live in int64 holding values in [0, 2**32), and every multiply and
add is followed by `& 0xFFFFFFFF`.  Multiplies by a 32-bit constant are
split into two 16-bit halves (`_mul32`) so no intermediate product leaves
the signed int64 range: the low 32 bits are exact without relying on
overflow wrapping.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .platform import DeviceLike, resolve_device

I32 = torch.int32

INF = 2**31 - 1

# Vote results as int codes matching quorum.VoteResult.
VOTE_PENDING = 0
VOTE_LOST = 1
VOTE_WON = 2

# State role codes matching raft.StateRole.
ROLE_FOLLOWER = 0
ROLE_CANDIDATE = 1
ROLE_LEADER = 2
ROLE_PRE_CANDIDATE = 3

_MASK32 = 0xFFFFFFFF


def majority_of(count: torch.Tensor) -> torch.Tensor:
    """Quorum size: n // 2 + 1 (reference: util.rs:118-120)."""
    return count // 2 + 1


def committed_index(
    matched: torch.Tensor,  # int32[..., P]
    voter_mask: torch.Tensor,  # bool[..., P]
) -> torch.Tensor:
    """Per-group quorum commit index over the last (peer) axis: the
    majority()-th largest matched value among voters, INF for an empty
    config (so a joint min() ignores that half).  Non-voters are masked to
    0, which only displaces other zeros because matched >= 0.  int32[...]."""
    masked = torch.where(voter_mask, matched, 0).to(torch.int32)
    srt = torch.sort(masked, dim=-1).values  # ascending
    count = voter_mask.sum(-1, dtype=torch.int32)
    p = matched.shape[-1]
    idx = torch.clamp(p - majority_of(count), 0, p - 1).to(torch.int64)
    quorum_idx = torch.gather(srt, -1, idx[..., None])[..., 0]
    return torch.where(count == 0, INF, quorum_idx)


def acting_leader_id(
    state: torch.Tensor,  # int32[P, G]
    term: torch.Tensor,  # int32[P, G]
    crashed: torch.Tensor,  # bool[P, G]
) -> torch.Tensor:
    """Per-group acting-leader peer id, int32[G] (1-based; 0 = no alive
    leader): the alive leader with the highest term, the lowest peer index
    on a tie."""
    P = state.shape[0]
    is_lead = (state == ROLE_LEADER) & ~crashed
    lead_term = torch.where(is_lead, term, -1).amax(0)
    acting = is_lead & (term == lead_term[None, :])
    p_idx = torch.arange(P, dtype=I32, device=state.device)[:, None]
    first = torch.where(acting, p_idx, P).amin(0)
    return torch.where(is_lead.any(0), first + 1, 0).to(I32)


def check_quorum_active(
    recent_active: torch.Tensor,  # bool[P, P, G]
    voter_mask: torch.Tensor,  # bool[P, G]
    outgoing_mask: torch.Tensor,  # bool[P, G]
) -> torch.Tensor:
    """bool[P, G]: whether owner p's recent_active row holds an active
    quorum of each (possibly joint) half; the owner itself always counts
    (reference: tracker.rs:346-372, quorum_recently_active)."""
    P = recent_active.shape[0]
    eye = torch.eye(P, dtype=torch.bool, device=recent_active.device)
    active = recent_active | eye[:, :, None]

    def half(mask):
        cnt = (active & mask[None, :, :]).sum(1, dtype=torch.int32)
        n = mask.sum(0, dtype=torch.int32)[None, :]
        return (cnt >= majority_of(n)) | (n == 0)

    return half(voter_mask) & half(outgoing_mask)


def cq_boundary_safe(
    recent_active: torch.Tensor,  # bool[P, P, G]
    voter_mask: torch.Tensor,  # bool[P, G]
    outgoing_mask: torch.Tensor,  # bool[P, G]
    state: torch.Tensor,  # int32[P, G]
    crashed: torch.Tensor,  # bool[P, G]
    election_elapsed: torch.Tensor,  # int32[P, G]
    horizon: int,
    election_tick: int,
    lossy: Optional[torch.Tensor] = None,  # bool[G]
) -> torch.Tensor:
    """bool[G]: every check-quorum boundary that can fire within `horizon`
    rounds provably passes.  Lossless: every alive leader's row holds an
    active quorum now, the alive voters form a quorum of each half (so a
    heartbeat interval re-saturates the row after a clear), and no crashed
    role-leader reaches its boundary.  Groups marked `lossy` need instead
    that no role-leader at all reaches its boundary in the horizon."""
    alive = ~crashed
    role_lead = state == ROLE_LEADER
    qa = check_quorum_active(recent_active, voter_mask, outgoing_mask)
    lead_ok = torch.where(role_lead & alive, qa, True).all(0)

    def half_alive(mask):
        cnt = (alive & mask).sum(0, dtype=torch.int32)
        n = mask.sum(0, dtype=torch.int32)
        return (cnt >= majority_of(n)) | (n == 0)

    alive_quorum = half_alive(voter_mask) & half_alive(outgoing_mask)
    before_boundary = election_elapsed + horizon < election_tick
    stale_ok = torch.where(role_lead & crashed, before_boundary, True).all(0)
    lossless_ok = lead_ok & alive_quorum & stale_ok
    if lossy is None:
        return lossless_ok
    no_boundary = torch.where(role_lead, before_boundary, True).all(0)
    return torch.where(lossy, no_boundary, lossless_ok)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c < 2**32,
    with every intermediate below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit murmur3 finalizer on int64 words holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


LOSS_SCALE = 10_000  # loss rates are int32 fixed-point per-ten-thousand


def link_loss_draw(
    round_idx: int,  # the round number, the replay key (int32 range)
    loss_rate: torch.Tensor,  # int32[P, P, G]
    group_ids: Optional[torch.Tensor] = None,  # int32[G]
) -> torch.Tensor:
    """Seeded per-link message-loss sample for one protocol round: bool[P,
    P, G], True where the (src, dst, group) link drops every message this
    round.  A counter PRNG keyed (round, src, dst, group), the same bits as
    the reference's link_loss_draw.  loss_rate is in units of 1/LOSS_SCALE;
    group_ids, when given, are the GLOBAL ids of a gathered sub-batch."""
    P, G = loss_rate.shape[0], loss_rate.shape[2]
    dev = loss_rate.device
    if group_ids is None:
        g = torch.arange(G, dtype=torch.int64, device=dev)
    else:
        g = group_ids.to(device=dev, dtype=torch.int64) & _MASK32
    s = torch.arange(P, dtype=torch.int64, device=dev)[:, None, None]
    d = torch.arange(P, dtype=torch.int64, device=dev)[None, :, None]
    lane = s * P + d + 1
    x = _mix32((_mul32(g, 0x9E3779B1) + (round_idx & _MASK32)) & _MASK32)
    x = x[None, None, :]
    x = _mix32(x ^ _mul32(lane, 0x85EBCA6B))
    return (x % LOSS_SCALE).to(torch.int32) < loss_rate


def _word_bits(acc: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as int32 tensors of the same bits (the
    reference's uint32 words)."""
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(I32)


def pack_bits(planes: torch.Tensor) -> torch.Tensor:
    """Pack K bool planes along axis 0 into ceil(K/32) 32-bit word planes:
    word w's bit j holds plane 32*w + j.  The words are int32 tensors
    holding the reference's uint32 bit patterns (bit 31 is the sign bit);
    they are built in int64, which every backend shifts and ORs."""
    k = planes.shape[0]
    bits = planes.to(torch.int64)
    words = []
    for w in range((k + 31) // 32):
        acc = torch.zeros(planes.shape[1:], dtype=torch.int64, device=planes.device)
        for j in range(min(32, k - 32 * w)):
            acc = acc | (bits[32 * w + j] << j)
        words.append(_word_bits(acc))
    return torch.stack(words)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_bits: int32[ceil(k/32), ...] words -> bool[k, ...].
    The arithmetic right shift of a word with bit 31 set copies the sign,
    which the `& 1` drops."""
    return torch.stack(
        [((words[j // 32] >> (j % 32)) & 1) != 0 for j in range(k)]
    )


def pack_u16_pairs(vals: torch.Tensor) -> torch.Tensor:
    """Pack K int32 planes of values below 2**16 (loss rates are at most
    LOSS_SCALE) into ceil(K/2) 32-bit word planes, even indices in the low
    halfword and odd ones in the high; int32 bit patterns as pack_bits'."""
    k = vals.shape[0]
    v = vals.to(torch.int64) & _MASK32
    words = []
    for w in range((k + 1) // 2):
        lo = v[2 * w]
        acc = lo | (v[2 * w + 1] << 16) if 2 * w + 1 < k else lo
        words.append(_word_bits(acc & _MASK32))
    return torch.stack(words)


def unpack_u16_pairs(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_u16_pairs: int32[ceil(k/2), ...] words -> int32[k,
    ...]."""
    return torch.stack(
        [(words[j // 2] >> (16 * (j % 2))) & 0xFFFF for j in range(k)]
    ).to(I32)


def pack_bits_g(plane: torch.Tensor) -> torch.Tensor:
    """Pack a bool plane 32:1 along its last (group) axis: bool[..., G] ->
    int32[..., ceil(G/32)], word w's bit j holding group 32*w + j (groups
    past G pad with zeros).  The words are int32 tensors holding the
    reference's uint32 bit patterns, built in int64 as pack_bits' are."""
    g = plane.shape[-1]
    n_words = (g + 31) // 32
    bits = plane.to(torch.int64)
    pad = n_words * 32 - g
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(plane.shape[:-1] + (n_words, 32))
    lanes = torch.arange(32, dtype=torch.int64, device=plane.device)
    # The bits are disjoint, so the shifted sum is a bitwise OR below 2**32.
    return _word_bits((bits << lanes).sum(-1))


def unpack_bits_g(words: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of pack_bits_g: int32[..., ceil(g/32)] -> bool[..., g]."""
    lanes = torch.arange(32, dtype=words.dtype, device=words.device)
    bits = (words[..., :, None] >> lanes) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :g] != 0


# check_safety violation-count vector indices.
SV_DUAL_LEADER = 0  # two leaders share a term in one group
SV_COMMIT_DIVERGED = 1  # two peers' committed prefixes disagree
SV_COMMIT_REGRESSED = 2  # some peer's commit index decreased
SV_CURSOR_INVALID = 3  # agree/commit cursors exceed log bounds
# Joint-window slots: checked only when the optional mask arguments are
# given; they stay zero otherwise, so every accumulator has one shape.
SV_LEADER_NOT_IN_CONFIG = 4  # a non-follower outside voter|outgoing
SV_COMMIT_NO_QUORUM = 5  # a commit advance lacking either joint majority
SV_CONF_DOUBLE_CHANGE = 6  # an illegal single-step membership transition
# Linearizability slots: checked only when the lease-read arguments are
# given (the same rule).
SV_STALE_READ = 7  # a lease-served read older than a fleet-committed index
SV_DUAL_LEASE = 8  # two peers hold a live read lease for one group at once
N_SAFETY = 9

SAFETY_NAMES = (
    "dual_leader",
    "commit_diverged",
    "commit_regressed",
    "cursor_invalid",
    "leader_not_in_config",
    "commit_no_quorum",
    "conf_double_change",
    "stale_read",
    "dual_lease",
)


def lease_read(
    state: torch.Tensor,  # int32[P, G]
    term: torch.Tensor,  # int32[P, G]
    leader_id: torch.Tensor,  # int32[P, G]
    election_elapsed: torch.Tensor,  # int32[P, G]
    commit: torch.Tensor,  # int32[P, G]
    term_start_index: torch.Tensor,  # int32[P, G]
    crashed: torch.Tensor,  # bool[P, G]
    election_tick: int,
    check_quorum: bool,
    transferee: Optional[torch.Tensor] = None,  # int32[P, G]
    recent_active: Optional[torch.Tensor] = None,  # bool[P, P, G]
    voter_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    outgoing_mask: Optional[torch.Tensor] = None,  # bool[P, G]
):
    """The batched LeaseBased read gate (read_only.rs LeaseBased and raft.rs
    step_leader's MsgReadIndex arm): which peers could serve a
    linearizable read locally, with zero message rounds, under the
    check-quorum leader lease, and what the group's acting leader would
    answer.

    A peer holds a live lease when `check_quorum` is on (static: without it
    the gate is constant-false, the undamped arm) and it is an uncrashed
    leader naming itself leader, inside its lease window (election_elapsed
    < election_tick), whose current recent_active row holds an active
    quorum of each config half, which has committed in its own term
    (commit >= term_start_index), and, when the `transferee` plane exists,
    with no leader transfer pending.

    Returns (holder bool[P, G], served bool[G], index int32[G]): the holder
    mask (at most one holder per group on every reachable state), whether
    the group's acting leader (acting_leader_id) holds one, and the commit
    index it would serve (0 where not served)."""
    P = state.shape[0]
    if not check_quorum:
        G, dev = state.shape[1], state.device
        return (
            torch.zeros((P, G), dtype=torch.bool, device=dev),
            torch.zeros((G,), dtype=torch.bool, device=dev),
            torch.zeros((G,), dtype=I32, device=dev),
        )
    if recent_active is None or voter_mask is None or outgoing_mask is None:
        raise ValueError(
            "the check-quorum lease gate needs recent_active, voter_mask "
            "and outgoing_mask (the damping planes)"
        )
    self_id = torch.arange(P, dtype=I32, device=state.device)[:, None] + 1
    holder = (
        (state == ROLE_LEADER)
        & ~crashed
        & (leader_id == self_id)
        & (election_elapsed < election_tick)
        & (commit >= term_start_index)
        & check_quorum_active(recent_active, voter_mask, outgoing_mask)
    )
    if transferee is not None:
        holder = holder & (transferee == 0)
    serving = holder & (self_id == acting_leader_id(state, term, crashed)[None, :])
    return holder, serving.any(0), torch.where(serving, commit, 0).sum(0, dtype=I32)


def _safety_groups(
    state, term, commit, last_index, agree, prev_commit, voter_mask,
    outgoing_mask, matched, crashed, prev_voter_mask, prev_outgoing_mask,
    lease_holder, lease_fire,
):
    """check_safety's invariants as N_SAFETY per-group bool[G] indicators,
    None for a slot whose optional arguments were not given."""
    P = state.shape[0]
    dev = state.device
    off_diag = ~torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    is_lead = state == ROLE_LEADER
    dual = (
        is_lead[:, None, :]
        & is_lead[None, :, :]
        & (term[:, None, :] == term[None, :, :])
        & off_diag
    )
    cmin = torch.minimum(commit[:, None, :], commit[None, :, :])
    diverged = (cmin > agree) & off_diag
    regressed = commit < prev_commit
    lmin = torch.minimum(last_index[:, None, :], last_index[None, :, :])
    invalid = ((agree > lmin) & off_diag) | (commit > last_index)[:, None, :]
    g_outside = g_unbacked = g_double = g_stale = g_dual_lease = None
    if voter_mask is not None:
        if outgoing_mask is None or matched is None:
            raise ValueError(
                "joint-window checks need voter_mask, outgoing_mask AND "
                "matched together"
            )
        non_follower = state != ROLE_FOLLOWER
        outside = non_follower & ~(voter_mask | outgoing_mask)
        g_outside = outside.any(0)
        alive = ~crashed if crashed is not None else torch.ones_like(is_lead)
        lead_alive = is_lead & alive
        max_alive_term = torch.where(lead_alive, term, -1).amax(0)
        checked = is_lead & (~alive | (term == max_alive_term[None, :]))
        owner_rows = matched.transpose(1, 2)  # [P_owner, G, P_target]

        def half(mask):
            return committed_index(
                owner_rows,
                mask.transpose(0, 1)[None, :, :].expand(owner_rows.shape),
            )

        mci = torch.minimum(half(voter_mask), half(outgoing_mask))  # [P, G]
        prev_high = prev_commit.amax(0)
        unbacked = checked & (commit > prev_high[None, :]) & (commit > mci)
        g_unbacked = unbacked.any(0)
    if prev_voter_mask is not None:
        if voter_mask is None or prev_outgoing_mask is None:
            raise ValueError(
                "the double-change check needs prev AND current masks"
            )
        was_j = prev_outgoing_mask.any(0)
        now_j = outgoing_mask.any(0)
        vm_delta = (prev_voter_mask ^ voter_mask).sum(0, dtype=I32)
        om_moved = (prev_outgoing_mask ^ outgoing_mask).any(0)
        enter_bad = (~was_j & now_j) & (outgoing_mask ^ prev_voter_mask).any(0)
        leave_bad = (was_j & ~now_j) & (vm_delta > 0)
        stay_bad = (was_j & now_j) & ((vm_delta > 0) | om_moved)
        simple_bad = (~was_j & ~now_j) & (vm_delta > 1)
        g_double = enter_bad | leave_bad | stay_bad | simple_bad
    if lease_holder is not None:
        g_dual_lease = lease_holder.sum(0, dtype=I32) >= 2
        if lease_fire is not None:
            fleet_high = prev_commit.amax(0)  # [G] at serve time
            stale = lease_holder & (prev_commit < fleet_high[None, :])
            g_stale = lease_fire & stale.any(0)
    elif lease_fire is not None:
        raise ValueError(
            "the stale-read check needs lease_holder alongside lease_fire"
        )
    return (
        dual.any(0).any(0),
        diverged.any(0).any(0),
        regressed.any(0),
        invalid.any(0).any(0),
        g_outside,
        g_unbacked,
        g_double,
        g_stale,
        g_dual_lease,
    )


def check_safety(
    state: torch.Tensor,  # int32[P, G]
    term: torch.Tensor,  # int32[P, G]
    commit: torch.Tensor,  # int32[P, G]
    last_index: torch.Tensor,  # int32[P, G]
    agree: torch.Tensor,  # int32[P, P, G]
    prev_commit: torch.Tensor,  # int32[P, G]
    voter_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    outgoing_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    matched: Optional[torch.Tensor] = None,  # int32[P, P, G]
    crashed: Optional[torch.Tensor] = None,  # bool[P, G]
    prev_voter_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    prev_outgoing_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    lease_holder: Optional[torch.Tensor] = None,  # bool[P, G]
    lease_fire: Optional[torch.Tensor] = None,  # bool[G]
) -> torch.Tensor:
    """Raft's safety invariants over one round boundary: int32[N_SAFETY]
    counts of violating groups (SV_* indices), all zero on every reachable
    state.

      * election safety: at most one leader per (group, term);
      * log matching at commit: min(commit_a, commit_b) <= agree[a, b];
      * commit monotonicity: no peer's commit index decreases;
      * cursor sanity: commit <= last_index and agree[a, b] <=
        min(last_a, last_b).

    With `voter_mask`, `outgoing_mask` and `matched` (the joint window):
    no non-follower outside both config halves; no commit past the round's
    starting high-water mark that the committing leader's own tracker row
    does not back under both majorities (crashed leaders and the max-term
    alive leaders are checked; a stale alive leader may learn a commit).
    With `prev_voter_mask` and `prev_outgoing_mask` as well: no illegal
    single-step membership change.  With `lease_holder` (and
    `lease_fire`): at most one live lease per group, and no lease-served
    read older than an index committed anywhere at serve time.  Every count
    is int32."""
    groups = _safety_groups(
        state, term, commit, last_index, agree, prev_commit, voter_mask,
        outgoing_mask, matched, crashed, prev_voter_mask, prev_outgoing_mask,
        lease_holder, lease_fire,
    )
    zero = torch.zeros((), dtype=I32, device=state.device)
    return torch.stack([zero if g is None else g.sum(dtype=I32) for g in groups])


def check_safety_groups(
    state: torch.Tensor,  # int32[P, G]
    term: torch.Tensor,  # int32[P, G]
    commit: torch.Tensor,  # int32[P, G]
    last_index: torch.Tensor,  # int32[P, G]
    agree: torch.Tensor,  # int32[P, P, G]
    prev_commit: torch.Tensor,  # int32[P, G]
    voter_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    outgoing_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    matched: Optional[torch.Tensor] = None,  # int32[P, P, G]
    crashed: Optional[torch.Tensor] = None,  # bool[P, G]
    prev_voter_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    prev_outgoing_mask: Optional[torch.Tensor] = None,  # bool[P, G]
    lease_holder: Optional[torch.Tensor] = None,  # bool[P, G]
    lease_fire: Optional[torch.Tensor] = None,  # bool[G]
) -> torch.Tensor:
    """The per-group form of check_safety, the black box's trigger surface:
    the same invariants over the same optional-argument matrix, as
    bool[N_SAFETY, G] violation indicators (an unchecked slot's row is
    all-False), whose row sums are check_safety's counts."""
    groups = _safety_groups(
        state, term, commit, last_index, agree, prev_commit, voter_mask,
        outgoing_mask, matched, crashed, prev_voter_mask, prev_outgoing_mask,
        lease_holder, lease_fire,
    )
    zero_g = torch.zeros(
        (state.shape[1],), dtype=torch.bool, device=state.device
    )
    return torch.stack([zero_g if g is None else g for g in groups])


def apply_confchange(
    state: torch.Tensor,  # int32[P, G]
    leader_id: torch.Tensor,  # int32[P, G]
    commit: torch.Tensor,  # int32[P, G]
    term_start_index: torch.Tensor,  # int32[P, G]
    matched: torch.Tensor,  # int32[P, P, G]
    voter_mask: torch.Tensor,  # bool[P, G]
    outgoing_mask: torch.Tensor,  # bool[P, G]
    learner_mask: torch.Tensor,  # bool[P, G]
    new_voter: torch.Tensor,  # bool[P, G]
    new_outgoing: torch.Tensor,  # bool[P, G]
    new_learner: torch.Tensor,  # bool[P, G]
    added: torch.Tensor,  # bool[P, G]
    removed: torch.Tensor,  # bool[P, G]
    apply_mask: torch.Tensor,  # bool[G]
    recent_active: Optional[torch.Tensor] = None,  # bool[P, P, G]
    transferee: Optional[torch.Tensor] = None,  # int32[P, G]
):
    """Commit one validated conf change in each group of `apply_mask`: swap
    the config mask planes for the pre-validated targets (new_voter,
    new_outgoing, new_learner; reconfig.compile_plan computes them with the
    scalar Changer) and run raft.rs's post_conf_change reactions.  Added
    and removed members (`added`, `removed`) get fresh tracker rows: their
    `matched` column is zeroed under every owner, and recent_active is
    granted to an added member and cleared for a removed one.  A peer
    acting above follower that lands outside voter|outgoing steps down
    (follower, leader_id 0).  A surviving leader picks up commits when the
    quorum shrinks: its joint commit bound under the new masks, the min of
    the two halves' committed_index over its own tracker row (an empty
    outgoing half gives INF), gated on its term start as
    raft_log.maybe_commit is.

    `transferee` (the lead_transferee plane of SimConfig(transfer=True))
    gets post_conf_change's abort (raft.rs:1356): a pending transfer whose
    target leaves the joint voter set, or whose owner the change steps
    down, is abandoned.

    Returns (state', leader_id', commit', matched', voter', outgoing',
    learner', recent_active', transferee'); recent_active and transferee
    pass through as None when absent."""
    ap = apply_mask[None, :]  # [1, G]
    vm = torch.where(ap, new_voter, voter_mask)
    om = torch.where(ap, new_outgoing, outgoing_mask)
    lm = torch.where(ap, new_learner, learner_mask)
    ap3 = apply_mask[None, None, :]
    matched2 = torch.where(ap3 & (added | removed)[None, :, :], 0, matched)
    ra = None
    if recent_active is not None:
        ra = torch.where(
            ap3 & added[None, :, :], True,
            torch.where(ap3 & removed[None, :, :], False, recent_active),
        )
    step_down = ap & (state != ROLE_FOLLOWER) & ~(vm | om)
    state2 = torch.where(step_down, ROLE_FOLLOWER, state)
    leader2 = torch.where(step_down, 0, leader_id)
    # Each owner's own tracker row against the new masks: [P_owner, G,
    # P_target].
    owner_rows = matched2.transpose(1, 2)
    mci = torch.minimum(
        committed_index(owner_rows, vm.t()[None].expand(owner_rows.shape)),
        committed_index(owner_rows, om.t()[None].expand(owner_rows.shape)),
    )  # [P_owner, G]
    pickup = (
        ap & (state2 == ROLE_LEADER) & (mci >= term_start_index) & (mci < INF)
    )
    commit2 = torch.where(pickup, torch.maximum(commit, mci), commit)
    tr = None
    if transferee is not None:
        # The pending target must stay in the joint voter set, and the
        # owner must survive the change as leader.
        P = transferee.shape[0]
        idx = torch.clamp(transferee - 1, 0, P - 1).to(torch.int64)
        tgt_in = torch.gather(vm | om, 0, idx)
        tr = torch.where(
            ap & (((transferee > 0) & ~tgt_in) | step_down), 0, transferee
        )
    return state2, leader2, commit2, matched2, vm, om, lm, ra, tr


def apply_transfer(
    transferee: torch.Tensor,  # int32[P, G]
    election_elapsed: torch.Tensor,  # int32[P, G]
    acting_leader: torch.Tensor,  # bool[P, G]
    propose: torch.Tensor,  # int32[G]
    member_mask: torch.Tensor,  # bool[P, G]
    learner_mask: torch.Tensor,  # bool[P, G]
):
    """The batched MsgTransferLeader step at each group's acting leader
    (raft.rs:1821-1889 handle_transfer_leader).  propose[g] is the round's
    command: the 1-based target (0 = none).  The target must be a member,
    not a learner and not the leader itself.  A pending transfer to the
    same target is left as it is; a command to another target aborts it
    and takes its place, and a command naming the leader itself aborts it
    before the self check refuses the command (the abort comes first in
    the reference).  An accepted command records the target in the
    leader's slot and resets its election_elapsed (the transfer clock,
    whose expiry aborts the transfer at tick time).  What the command
    queues (the catch-up append or MsgTimeoutNow) is sim._transfer_phase's
    pump.

    Returns (transferee', election_elapsed', accepted bool[G]), accepted
    marking the groups whose command was newly recorded."""
    P = transferee.shape[0]
    tgt = torch.clamp(propose - 1, 0, P - 1).to(torch.int64)[None, :]  # [1, G]
    tgt_member = torch.gather(member_mask, 0, tgt)[0]
    tgt_learner = torch.gather(learner_mask, 0, tgt)[0]
    # The acting leader's peer id and current lead_transferee, per group.
    p_id = torch.arange(P, dtype=I32, device=transferee.device)[:, None] + 1
    lead_id = torch.where(acting_leader, p_id, 0).sum(0, dtype=I32)  # [G]
    cur = torch.where(acting_leader, transferee, 0).sum(0, dtype=I32)  # [G]
    checked = (propose > 0) & (lead_id > 0) & tgt_member & ~tgt_learner
    accepted = checked & (propose != lead_id) & (propose != cur)
    self_abort = checked & (propose == lead_id) & (cur > 0)
    set_here = acting_leader & accepted[None, :]
    transferee2 = torch.where(acting_leader & self_abort[None, :], 0, transferee)
    transferee2 = torch.where(set_here, propose[None, :], transferee2)
    ee2 = torch.where(set_here, 0, election_elapsed)
    return transferee2, ee2, accepted


def timeout_draw(
    node_key: torch.Tensor,  # int64[...] holding uint32 values
    epoch: torch.Tensor,  # int64[...] holding uint32 values
    lo: torch.Tensor,  # int32[...]
    hi: torch.Tensor,  # int32[...]
) -> torch.Tensor:
    """Randomized election timeout in [lo, hi) — the same 32-bit
    murmur3-finalizer mix as the reference's timeout_draw.  Returns int32."""
    x = (_mul32(node_key & _MASK32, 0x9E3779B1) + (epoch & _MASK32)) & _MASK32
    x = _mix32(x)
    span = (hi.to(torch.int64) - lo.to(torch.int64)) & _MASK32
    out = ((lo.to(torch.int64) & _MASK32) + x % span) & _MASK32
    # uint32 -> int32 reinterpretation, as the reference's astype does.
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32)


# --- the event-counter plane: indices into the [N_COUNTERS] int32
# accumulator that `sim.step` sums when given `counters`.
CTR_CAMPAIGNS = 0  # election timers fired (scalar: Raft.campaign calls)
CTR_HEARTBEATS = 1  # leader heartbeat timers fired (scalar: MsgBeat steps)
CTR_ELECTIONS_WON = 2  # leaders elected (scalar: become_leader calls)
CTR_COMMIT_ENTRIES = 3  # sum of per-peer commit-index advances
N_COUNTERS = 4

COUNTER_NAMES = (
    "campaigns",
    "heartbeats",
    "elections_won",
    "commit_entries",
)


def zero_counters(device: DeviceLike = None) -> torch.Tensor:
    """Fresh [N_COUNTERS] int32 accumulator plane, on `cuda` unless
    `device` says otherwise."""
    return torch.zeros((N_COUNTERS,), dtype=I32, device=resolve_device(device))


def count_events(
    counters: torch.Tensor,  # int32[N_COUNTERS]
    want_campaign: torch.Tensor,  # bool[...]
    want_heartbeat: torch.Tensor,  # bool[...]
    won: torch.Tensor,  # bool[...]
    commit_delta: torch.Tensor,  # int32[...]
) -> torch.Tensor:
    """Fold one round's event masks into the accumulator plane; every sum
    is int32 (it wraps modulo 2**32, as the reference's does)."""
    events = torch.stack([
        want_campaign.sum(dtype=I32),
        want_heartbeat.sum(dtype=I32),
        won.sum(dtype=I32),
        commit_delta.sum(dtype=I32),
    ]).to(counters.dtype)
    return counters + events


# --- the fleet-health planes: row indices into the [N_HEALTH_PLANES, G]
# int32 stack that `sim.step` maintains when given a health state.
HP_LEADERLESS = 0  # consecutive rounds the group ended with no alive leader
HP_SINCE_COMMIT = 1  # consecutive rounds the group's max commit was flat
HP_TERM_BUMPS = 2  # max-term growth inside the current churn window
HP_VOTE_SPLITS = 3  # cumulative election rounds that elected nobody
N_HEALTH_PLANES = 4

HEALTH_PLANE_NAMES = (
    "leaderless_ticks",
    "ticks_since_commit",
    "term_bumps_in_window",
    "vote_splits",
)

# Commit-lag histogram bucket lower bounds (ticks_since_commit); bucket i
# counts groups with LAG_BUCKET_BOUNDS[i-1] <= lag < LAG_BUCKET_BOUNDS[i],
# bucket 0 is lag == 0 and the last bucket is lag >= 64.
LAG_BUCKET_BOUNDS = (1, 2, 4, 8, 16, 32, 64)
N_LAG_BUCKETS = len(LAG_BUCKET_BOUNDS) + 1

# health_summary count-vector indices.
HS_LEADERLESS = 0  # groups currently leaderless (any duration)
HS_STALLED_LEADERLESS = 1  # leaderless at/over the stall threshold
HS_COMMIT_STALLED = 2  # commit-flat at/over the stall threshold
HS_CHURNING = 3  # term bumps in window at/over the churn threshold
N_HEALTH_COUNTS = 4

HEALTH_COUNT_NAMES = (
    "leaderless",
    "stalled_leaderless",
    "commit_stalled",
    "churning",
)


def zero_health(n_groups: int, device: DeviceLike = None) -> torch.Tensor:
    """Fresh [N_HEALTH_PLANES, n_groups] int32 health-plane stack, on `cuda`
    unless `device` says otherwise."""
    return torch.zeros(
        (N_HEALTH_PLANES, n_groups), dtype=I32, device=resolve_device(device)
    )


def update_health(
    planes: torch.Tensor,  # int32[N_HEALTH_PLANES, G]
    window_pos: int,
    window: int,
    has_leader: torch.Tensor,  # bool[G]
    commit_advanced: torch.Tensor,  # bool[G]
    term_bump: torch.Tensor,  # int32[G]
    vote_split: torch.Tensor,  # bool[G]
) -> Tuple[torch.Tensor, int]:
    """Fold one protocol round into the health planes; returns (planes',
    window_pos').  The churn window resets at the start of the round whose
    window_pos is 0.  The reference keeps window_pos as a device int32
    scalar; every change to it is host-known arithmetic, so here it is a
    Python int and the fold needs no device sync."""
    leaderless = torch.where(has_leader, 0, planes[HP_LEADERLESS] + 1)
    since = torch.where(commit_advanced, 0, planes[HP_SINCE_COMMIT] + 1)
    kept = torch.zeros_like(term_bump) if window_pos == 0 else planes[HP_TERM_BUMPS]
    bumps = kept + term_bump
    splits = planes[HP_VOTE_SPLITS] + vote_split.to(I32)
    return torch.stack([leaderless, since, bumps, splits]), (window_pos + 1) % window


def health_summary(
    planes: torch.Tensor,  # int32[N_HEALTH_PLANES, G]
    stall_ticks: int,
    commit_stall_ticks: int,
    churn_bumps: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The planes reduced to a fixed-size summary on their device: (counts
    [N_HEALTH_COUNTS], lag_hist [N_LAG_BUCKETS], worst_ids [k],
    worst_scores [k]), all int32.  The worst-offender score is
    max(ticks_since_commit, leaderless_ticks); ties go to the lower group
    id, as `lax.top_k` breaks them, by a stable descending sort."""
    leaderless = planes[HP_LEADERLESS]
    lag = planes[HP_SINCE_COMMIT]
    bumps = planes[HP_TERM_BUMPS]
    counts = torch.stack([
        (leaderless > 0).sum(dtype=I32),
        (leaderless >= stall_ticks).sum(dtype=I32),
        (lag >= commit_stall_ticks).sum(dtype=I32),
        (bumps >= churn_bumps).sum(dtype=I32),
    ])
    bounds = torch.tensor(LAG_BUCKET_BOUNDS, dtype=I32, device=planes.device)
    bucket = (lag[:, None] >= bounds[None, :]).sum(1, dtype=I32)
    hist = torch.zeros((N_LAG_BUCKETS,), dtype=I32, device=planes.device)
    hist = hist.scatter_add(0, bucket.to(torch.int64), torch.ones_like(bucket))
    score = torch.maximum(lag, leaderless)
    ordered = torch.sort(score, descending=True, stable=True)
    return (
        counts,
        hist,
        ordered.indices[:k].to(I32),
        ordered.values[:k].to(I32),
    )


# --- the black-box flight recorder (the forensics layer) -----------------
#
# A [W, G] ring of per-group round records plus a first-trip plane, carried
# behind SimConfig(blackbox=True), so that a nonzero safety count can be
# traced to the offending group and round.  Ring word layout (the
# reference's uint32 word, held in an int32 tensor; 15 of 32 bits used):
#   bits 0-1   group max ROLE_* code (< 4)
#   bits 2-5   acting leader peer id (acting_leader_id, 0..n_peers < 16)
#   bits 6-14  the round's N_SAFETY fired-slot indicators
BB_LEADER_SHIFT = 2
BB_SAFETY_SHIFT = 6
BB_META_BITS = BB_SAFETY_SHIFT + N_SAFETY


def pack_blackbox_meta(
    role: torch.Tensor,  # int32[...]
    leader_id: torch.Tensor,  # int32[...]
    safety_bits: torch.Tensor,  # int32[...] holding uint32 bits
) -> torch.Tensor:
    """One ring record's word (layout above): int32 tensors holding the
    reference's uint32 bits, built in int64 as pack_bits_g's are."""
    word = (
        role.to(torch.int64)
        | (leader_id.to(torch.int64) << BB_LEADER_SHIFT)
        | (safety_bits.to(torch.int64) << BB_SAFETY_SHIFT)
    ) & _MASK32
    return _word_bits(word)


def unpack_blackbox_meta(
    word: torch.Tensor,  # int32[...] holding uint32 bits
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of pack_blackbox_meta: word -> (role, leader_id,
    safety_bits), int32 each."""
    role = word & 3
    leader = (word >> BB_LEADER_SHIFT) & 0xF
    bits = (word >> BB_SAFETY_SHIFT) & ((1 << N_SAFETY) - 1)
    return role, leader, bits


def zero_blackbox(n_groups: int, window: int, device: DeviceLike = None):
    """Fresh black-box planes: (meta int32[W, G], term int32[W, G], commit
    int32[W, G], trip_round int32[N_SAFETY, G] at INF = never tripped,
    round_idx 0), on `cuda` unless `device` says otherwise.  round_idx is
    a Python int: every change to it is host-known arithmetic."""
    dev = resolve_device(device)
    ring = (window, n_groups)
    return (
        torch.zeros(ring, dtype=I32, device=dev),
        torch.zeros(ring, dtype=I32, device=dev),
        torch.zeros(ring, dtype=I32, device=dev),
        torch.full((N_SAFETY, n_groups), INF, dtype=I32, device=dev),
        0,
    )


def _safety_bits(viol: torch.Tensor) -> torch.Tensor:
    """bool[N_SAFETY, G] -> int64[G] fired-slot bits (slot s at bit s)."""
    lanes = torch.arange(N_SAFETY, dtype=torch.int64, device=viol.device)
    # The bits are disjoint, so the shifted sum is a bitwise OR.
    return (viol.to(torch.int64) << lanes[:, None]).sum(0)


def _set_ring_row(ring: torch.Tensor, slot: int, row: torch.Tensor) -> torch.Tensor:
    out = ring.clone()
    out[slot] = row
    return out


def blackbox_fold(
    meta_ring: torch.Tensor,  # int32[W, G]
    term_ring: torch.Tensor,  # int32[W, G]
    commit_ring: torch.Tensor,  # int32[W, G]
    trip_round: torch.Tensor,  # int32[N_SAFETY, G]
    round_idx: int,
    state: torch.Tensor,  # int32[P, G]
    term: torch.Tensor,  # int32[P, G]
    commit: torch.Tensor,  # int32[P, G]
    crashed: torch.Tensor,  # bool[P, G]
    viol: torch.Tensor,  # bool[N_SAFETY, G]
):
    """Fold one round into the black box: ring slot round_idx % W gets the
    packed (group max role, acting leader, fired bits) word, the group max
    term and the group max commit, and the first-trip plane takes
    round_idx where `viol` (check_safety_groups' output for the round)
    fired and no earlier round had.  Returns fresh (meta, term, commit,
    trip_round) planes and round_idx + 1.  Callers without a safety audit
    pass all-False `viol`; blackbox_mark stamps the bits in later."""
    slot = round_idx % meta_ring.shape[0]
    word = pack_blackbox_meta(
        state.amax(0), acting_leader_id(state, term, crashed), _safety_bits(viol)
    )
    return (
        _set_ring_row(meta_ring, slot, word),
        _set_ring_row(term_ring, slot, term.amax(0)),
        _set_ring_row(commit_ring, slot, commit.amax(0)),
        torch.where(viol, trip_round.clamp(max=round_idx), trip_round),
        round_idx + 1,
    )


def blackbox_mark(
    meta_ring: torch.Tensor,  # int32[W, G]
    trip_round: torch.Tensor,  # int32[N_SAFETY, G]
    round_idx: int,
    viol: torch.Tensor,  # bool[N_SAFETY, G]
):
    """Stamp a violation mask onto the last folded round (round_idx - 1):
    OR its fired bits into that ring word and min-fold the trip plane.
    Returns fresh (meta, trip_round).  On a fresh recorder (round_idx 0,
    no round folded) it changes nothing."""
    if round_idx == 0:
        return meta_ring, trip_round
    r = round_idx - 1
    slot = r % meta_ring.shape[0]
    bits = _word_bits(_safety_bits(viol) << BB_SAFETY_SHIFT)
    return (
        _set_ring_row(meta_ring, slot, meta_ring[slot] | bits),
        torch.where(viol, trip_round.clamp(max=r), trip_round),
    )


def blackbox_capture(
    trip_round: torch.Tensor,  # int32[N_SAFETY, G]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first-trip plane reduced to a fixed-size capture on its device:
    (counts int32[N_SAFETY], ids int32[N_SAFETY, k], rounds int32[N_SAFETY,
    k]): per slot, how many groups ever tripped it and the first k
    offenders in (trip round, group id) order; unfilled lanes hold -1.
    `lax.top_k` breaks ties toward the lower group id, and so does a
    stable ascending sort."""
    counts = (trip_round < INF).sum(1, dtype=I32)
    ordered = torch.sort(trip_round, dim=1, stable=True)
    rounds = ordered.values[:, :k]
    got = rounds < INF
    return (
        counts,
        torch.where(got, ordered.indices[:, :k].to(I32), -1),
        torch.where(got, rounds, -1),
    )


def tick_kernel(
    state: torch.Tensor,  # int32[...]
    election_elapsed: torch.Tensor,  # int32[...]
    heartbeat_elapsed: torch.Tensor,  # int32[...]
    randomized_timeout: torch.Tensor,  # int32[...]
    promotable: torch.Tensor,  # bool[...]
    election_timeout: int,
    heartbeat_timeout: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One logical-clock tick for every node (reference: raft.rs:1024-1079).

    Returns (election_elapsed', heartbeat_elapsed', want_campaign,
    want_heartbeat, want_check_quorum), as the reference's tick_kernel."""
    is_leader = state == ROLE_LEADER

    ee = election_elapsed + 1
    hb = torch.where(is_leader, heartbeat_elapsed + 1, heartbeat_elapsed)

    pass_election = ee >= randomized_timeout
    want_campaign = ~is_leader & pass_election & promotable
    ee = torch.where(want_campaign, 0, ee)

    want_check_quorum = is_leader & (ee >= election_timeout)
    ee = torch.where(want_check_quorum, 0, ee)

    want_heartbeat = is_leader & (hb >= heartbeat_timeout)
    hb = torch.where(want_heartbeat, 0, hb)

    return ee, hb, want_campaign, want_heartbeat, want_check_quorum
