"""The plain reference of the benchmark's Raft round: G groups x P peers in
peer-major [P, G] int32/bool tensors, advanced one lockstep protocol round
at a time in plain PyTorch, with no kernel, no fused block and no cache.

It is a frozen copy of the general round of the program under test
(`raft_tpu_torch.multiraft.sim`: the undamped round `_plain_step` and the
check-quorum / pre-vote round `_damped_linked_step` under an all-up link
plane), cut to what the benchmark's deployments run: no counters, health,
black box, leader transfer, client reads or link faults.  Of
reconfiguration it keeps what the round itself does (the masks' quorums
and elections, and where a proposal lands: `step(lead=)`); the
conf-change protocol around the round is `confchange.py`'s.
The program may change; this file does not, so it keeps the semantics the
benchmark holds the program to: raft-rs's protocol round by round, as the
JAX package defines it and the port's CPU tests hold bit for bit.  It
imports nothing of the program.  Every tensor it returns is fresh.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

I32 = torch.int32
INF = 2**31 - 1
_MASK32 = 0xFFFFFFFF

ROLE_FOLLOWER = 0
ROLE_CANDIDATE = 1
ROLE_LEADER = 2
ROLE_PRE_CANDIDATE = 3


class Config(NamedTuple):
    """A deployment's protocol settings (raft-rs `Config`)."""

    n_groups: int
    n_peers: int
    election_tick: int = 10
    heartbeat_tick: int = 1
    check_quorum: bool = False
    pre_vote: bool = False

    @property
    def min_timeout(self) -> int:
        return self.election_tick

    @property
    def max_timeout(self) -> int:
        return 2 * self.election_tick


class State(NamedTuple):
    """Per-peer Raft state, peer-major; the field names of the program's
    state, so the two compare field by field."""

    term: torch.Tensor  # int32[P, G]
    state: torch.Tensor  # int32[P, G]: ROLE_*
    vote: torch.Tensor  # int32[P, G]: 0 none, else the peer id 1..P
    leader_id: torch.Tensor  # int32[P, G]: each peer's view, 0 none
    election_elapsed: torch.Tensor  # int32[P, G]
    heartbeat_elapsed: torch.Tensor  # int32[P, G]
    randomized_timeout: torch.Tensor  # int32[P, G]
    last_index: torch.Tensor  # int32[P, G]
    last_term: torch.Tensor  # int32[P, G]
    commit: torch.Tensor  # int32[P, G]
    matched: torch.Tensor  # int32[P, P, G]: per-owner Progress.matched
    term_start_index: torch.Tensor  # int32[P, G]: the owner's noop index
    agree: torch.Tensor  # int32[P, P, G]: pairwise common-prefix length
    voter_mask: torch.Tensor  # bool[P, G]
    outgoing_mask: torch.Tensor  # bool[P, G]
    learner_mask: torch.Tensor  # bool[P, G]
    recent_active: Optional[torch.Tensor] = None  # bool[P, P, G], damped only


FIELDS = State._fields


def majority_of(count: torch.Tensor) -> torch.Tensor:
    """Quorum size n // 2 + 1 (raft-rs util.rs)."""
    return count // 2 + 1


def committed_index(matched: torch.Tensor, voter_mask: torch.Tensor) -> torch.Tensor:
    """The majority()-th largest matched value among voters along the last
    axis; INF for an empty config."""
    masked = torch.where(voter_mask, matched, 0).to(I32)
    srt = torch.sort(masked, dim=-1).values
    count = voter_mask.sum(-1, dtype=I32)
    p = matched.shape[-1]
    idx = torch.clamp(p - majority_of(count), 0, p - 1).to(torch.int64)
    quorum_idx = torch.gather(srt, -1, idx[..., None])[..., 0]
    return torch.where(count == 0, INF, quorum_idx)


def check_quorum_active(recent_active, voter_mask, outgoing_mask) -> torch.Tensor:
    """bool[P, G]: owner p's recent_active row holds an active quorum of
    each half; the owner itself always counts (tracker.rs)."""
    P = recent_active.shape[0]
    eye = torch.eye(P, dtype=torch.bool, device=recent_active.device)
    active = recent_active | eye[:, :, None]

    def half(mask):
        cnt = (active & mask[None, :, :]).sum(1, dtype=I32)
        n = mask.sum(0, dtype=I32)[None, :]
        return (cnt >= majority_of(n)) | (n == 0)

    return half(voter_mask) & half(outgoing_mask)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit murmur3 finalizer on int64 words holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def timeout_draw(node_key, epoch, lo, hi) -> torch.Tensor:
    """The randomized election timeout in [lo, hi), keyed on the node and
    its term."""
    x = (_mul32(node_key & _MASK32, 0x9E3779B1) + (epoch & _MASK32)) & _MASK32
    x = _mix32(x)
    span = (hi.to(torch.int64) - lo.to(torch.int64)) & _MASK32
    out = ((lo.to(torch.int64) & _MASK32) + x % span) & _MASK32
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(I32)


def tick_kernel(state, election_elapsed, heartbeat_elapsed, randomized_timeout,
                promotable, election_timeout: int, heartbeat_timeout: int):
    """One logical-clock tick for every node (raft.rs tick_election and
    tick_heartbeat): (ee', hb', want_campaign, want_heartbeat,
    want_check_quorum)."""
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


def node_key(cfg: Config, device, group_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """node_key[p, g] = g * 2**16 + (p + 1) mod 2**32 as int64 words; g is
    the group's global id (`group_ids`, or 0..G-1)."""
    if group_ids is None:
        g = torch.arange(cfg.n_groups, dtype=torch.int64, device=device)
    else:
        g = group_ids.to(device=device, dtype=torch.int64) & _MASK32
    p = torch.arange(cfg.n_peers, dtype=torch.int64, device=device)[:, None]
    return (g[None, :] * (1 << 16) + (p + 1)) & _MASK32


def init_state(cfg: Config, device, group_ids: Optional[torch.Tensor] = None) -> State:
    """Every peer a voting follower at term 0 with its deterministic
    timeout draw; a damped config gets an all-False recent_active plane."""
    G, P = cfg.n_groups, cfg.n_peers
    shape = (P, G)

    def zeros():
        return torch.zeros(shape, dtype=I32, device=device)

    lo = torch.full(shape, cfg.min_timeout, dtype=I32, device=device)
    hi = torch.full(shape, cfg.max_timeout, dtype=I32, device=device)
    rt = timeout_draw(node_key(cfg, device, group_ids),
                      torch.zeros(shape, dtype=torch.int64, device=device), lo, hi)
    damped = cfg.check_quorum or cfg.pre_vote
    return State(
        term=zeros(), state=zeros(), vote=zeros(), leader_id=zeros(),
        election_elapsed=zeros(), heartbeat_elapsed=zeros(),
        randomized_timeout=rt, last_index=zeros(), last_term=zeros(),
        commit=zeros(),
        matched=torch.zeros((P, P, G), dtype=I32, device=device),
        term_start_index=zeros(),
        agree=torch.zeros((P, P, G), dtype=I32, device=device),
        voter_mask=torch.ones(shape, dtype=torch.bool, device=device),
        outgoing_mask=torch.zeros(shape, dtype=torch.bool, device=device),
        learner_mask=torch.zeros(shape, dtype=torch.bool, device=device),
        recent_active=(torch.zeros((P, P, G), dtype=torch.bool, device=device)
                       if damped else None),
    )


def step(cfg: Config, st: State, crashed: torch.Tensor, append_n: torch.Tensor,
         group_ids: Optional[torch.Tensor] = None, lead: Optional[list] = None) -> State:
    """One lockstep round for every group.  crashed: bool[P, G] peers
    isolated this round (they keep ticking and exchange no messages);
    append_n: int32[G] entries proposed at each group's leader; group_ids:
    the groups' global ids where `st` holds a subset of the fleet.  With a
    list `lead`, the round appends to it where the proposals landed:
    (has_leader bool[G], the acting leader's 0-based slot int32[G], its
    last index after the round's appends int32[G], its term int32[G])."""
    key = node_key(cfg, st.term.device, group_ids)
    if cfg.check_quorum or cfg.pre_vote:
        link = torch.ones((cfg.n_peers, cfg.n_peers, cfg.n_groups),
                          dtype=torch.bool, device=st.term.device)
        return _damped_linked_step(cfg, st, crashed, append_n, link, key, lead)
    return _plain_step(cfg, st, crashed, append_n, key, lead)


def _sort_rows_desc(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Descending odd-even transposition sorting network over P rows of [G]
    vectors (a sort along the peer axis)."""
    n = len(rows)
    rows = list(rows)
    for pass_ in range(n):
        for i in range(pass_ % 2, n - 1, 2):
            hi = torch.maximum(rows[i], rows[i + 1])
            lo = torch.minimum(rows[i], rows[i + 1])
            rows[i], rows[i + 1] = hi, lo
    return rows


def _quorum_pick(
    matched: torch.Tensor, voter_mask: torch.Tensor, qpos: torch.Tensor
) -> torch.Tensor:
    """The value at position `qpos` [G] of each group's voter slots of
    `matched` [P, G] sorted in descending order (non-voters count as 0),
    by the odd-even network.  int32[G]."""
    P = matched.shape[0]
    rows = _sort_rows_desc(
        [torch.where(voter_mask[p], matched[p], 0) for p in range(P)]
    )
    out = torch.zeros_like(rows[0])
    for p in range(P):
        out = torch.where(qpos == p, rows[p], out)
    return out


def _quorum_index(matched: torch.Tensor, voter_mask: torch.Tensor) -> torch.Tensor:
    """Per-group majority commit index over the peer axis of [P, G] planes
    (reference: majority.rs:70-124); INF for an empty config.  int32[G]."""
    count = voter_mask.sum(0, dtype=I32)
    return torch.where(
        count == 0, INF, _quorum_pick(matched, voter_mask, count // 2)
    )


def _weighted_row(plane: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """sum over the owner axis of plane[o, ...] * f[o] in int32: the row of
    the one owner whose 0/1 weight f is set (zeros where none is)."""
    if plane.dim() == 3:
        f = f[:, None, :]
    return (plane * f).sum(0, dtype=I32)
def _merge_agree(agree, in_set, value, lead_row):
    """One wholesale-adoption agreement event: pairs inside `in_set` agree
    to `value` [G]; a pair with one side inside inherits `lead_row` [P, G]
    (the sender's agreement row) at the other side; the rest keep
    `agree`."""
    return torch.where(
        in_set[:, None, :] & in_set[None, :, :],
        value[None, None, :],
        torch.where(
            in_set[:, None, :],
            lead_row[None, :, :],
            torch.where(in_set[None, :, :], lead_row[:, None, :], agree),
        ),
    )


def _set_row(plane: torch.Tensor, sid: int, row: torch.Tensor) -> torch.Tensor:
    """A fresh plane equal to `plane` with row `sid` replaced by `row`."""
    out = plane.clone()
    out[sid] = row
    return out


def _half_quorums(st: State):
    """(n_i, n_o, q_i, q_o): each config half's voter count and quorum."""
    n_i = st.voter_mask.sum(0, dtype=I32)
    n_o = st.outgoing_mask.sum(0, dtype=I32)
    return n_i, n_o, majority_of(n_i), majority_of(n_o)


def _decided(cnt_i, cnt_o, rec_i, rec_o, quorums):
    """(won, lost) of a tally so far: both halves granted a quorum (or are
    empty), or some half can no longer reach one."""
    n_i, n_o, q_i, q_o = quorums
    won = ((cnt_i >= q_i) | (n_i == 0)) & ((cnt_o >= q_o) | (n_o == 0))
    lost = ((n_i > 0) & (cnt_i + (n_i - rec_i) < q_i)) | (
        (n_o > 0) & (cnt_o + (n_o - rec_o) < q_o)
    )
    return won, lost


def _real_tally(st, C, active, grants, resps, snaps, Erev, agree):
    """The per-candidate vote tally in voter order with the scalar win/loss
    cutoffs (wave 2 of the damped round).  active bool[P, G]: candidates
    still campaigning; grants[s], resps[s], snaps[s] [P_v, G]: s's grants,
    responses and reject-time
    commit snapshots; `agree` [P, P, G] the agreement rows the commit
    fast-forward checks.  Returns (C', won, lost)."""
    P = active.shape[0]
    quorums = _half_quorums(st)
    won_rows, lost_rows = [], []
    for sid in range(P):
        act = active[sid]
        del_g = grants[sid] & Erev[sid]
        del_r = (resps[sid] & ~grants[sid]) & Erev[sid]
        cnt_i = (act & st.voter_mask[sid]).to(I32)  # self-vote
        cnt_o = (act & st.outgoing_mask[sid]).to(I32)
        rec_i, rec_o = cnt_i, cnt_o
        ff = torch.zeros_like(C[sid])
        for v in range(P):
            won_before, lost_before = _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)
            snap_v = snaps[sid][v]
            ok = del_r[v] & ~won_before & ~lost_before & (snap_v <= agree[sid][v])
            ff = torch.where(ok, torch.maximum(ff, snap_v), ff)
            resp_v = del_g[v] | del_r[v]
            rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
            rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
            cnt_i = cnt_i + (del_g[v] & st.voter_mask[v]).to(I32)
            cnt_o = cnt_o + (del_g[v] & st.outgoing_mask[v]).to(I32)
        won_ci, lost_ci = _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)
        won_ci = act & won_ci
        C = _set_row(C, sid, torch.maximum(C[sid], ff))
        won_rows.append(won_ci)
        lost_rows.append(act & ~won_ci & lost_ci)
    return C, torch.stack(won_rows), torch.stack(lost_rows)


def _cut_before(eff: torch.Tensor, dim: int) -> torch.Tensor:
    """True strictly after the first True along `dim`: the response-stream
    cutoff, where a deposed sender ignores everything later in its
    stream.  The cumsum is pinned to int32 (it widens to int64 otherwise)."""
    e = eff.to(I32)
    return (torch.cumsum(e, dim=dim, dtype=I32) - e) > 0


def _plain_step(
    cfg: Config,
    st: State,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    node_key: torch.Tensor,  # int64[P, G]
    lead: Optional[list] = None,
):
    """The undamped round (raft-rs with check_quorum and pre_vote off):
    tick, campaign, election resolution, the solo crashed-campaigner win,
    then replication and the quorum commit."""
    G, P = cfg.n_groups, cfg.n_peers
    dev = st.term.device
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)

    def draw(term):
        return timeout_draw(
            node_key, term.to(torch.int64) & 0xFFFFFFFF, lo, hi
        )

    # ---- Phase A: tick every peer (crashed peers tick too).
    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask
    ee, hb, want_campaign, want_heartbeat, want_cq = tick_kernel(
        st.state,
        st.election_elapsed,
        st.heartbeat_elapsed,
        st.randomized_timeout,
        promotable,
        cfg.election_tick,
        cfg.heartbeat_tick,
    )

    # ---- Phase B: campaigners become candidates: term+1, vote self, redraw.
    term = st.term + want_campaign.to(I32)
    state = torch.where(want_campaign, ROLE_CANDIDATE, st.state)
    vote = torch.where(want_campaign, self_id, st.vote)
    leader_id = torch.where(want_campaign, 0, st.leader_id)
    rt = torch.where(want_campaign, draw(term), st.randomized_timeout)

    # ---- Phase C: election resolution among alive requesters, run only in
    # a round where some alive peer campaigns (every write in it is masked
    # on this round's campaigners).
    req = want_campaign & alive

    def elect(term, state, vote, leader_id, ee, hb, rt, li, lt, matched, ts,
              commit):
        any_req = req.any(0)  # [G]
        t_star = torch.where(req, term, 0).amax(0)  # [G]

        # Deposed-leader heartbeat interleaving (see the reference).
        prev_leader = (state == ROLE_LEADER) & alive
        prev_has = prev_leader.any(0)
        prev_lt = torch.where(prev_leader, term, -1).amax(0)
        prev_acting = prev_leader & (term == prev_lt)
        prev_first = torch.where(prev_acting, p_idx, P).amin(0)
        prev_is_acting = (p_idx == prev_first) & prev_has
        beat = (want_heartbeat & prev_is_acting).any(0)
        deposed = prev_has & (t_star > prev_lt) & any_req
        first_req = torch.where(req, p_idx, P).amin(0)
        hb_first = prev_first < first_req
        prev_row = _weighted_row(matched, prev_is_acting.to(I32))  # [P, G]
        prev_commit = torch.where(prev_is_acting, commit, 0).amax(0)
        hb_val = torch.minimum(prev_row, prev_commit[None, :])
        apply_v = (
            deposed & beat & hb_first & alive & promotable
            & (term <= prev_lt) & ~prev_is_acting
        )
        apply_l = deposed & beat & alive & st.learner_mask & (term <= prev_lt)
        commit = torch.where(
            apply_v | apply_l, torch.maximum(commit, hb_val), commit
        )
        ee = torch.where(apply_l, 0, ee)
        leader_id = torch.where(apply_l, prev_first + 1, leader_id)
        lrn_bump = apply_l & (term < prev_lt)
        term = torch.where(lrn_bump, prev_lt, term)
        vote = torch.where(lrn_bump, 0, vote)
        rt = torch.where(lrn_bump, draw(term), rt)

        # A higher-term request makes any alive voter a follower at t_star.
        bump = alive & promotable & (term < t_star) & any_req
        term_c = torch.where(bump, t_star, term)
        state_c = torch.where(bump, ROLE_FOLLOWER, state)
        vote_c = torch.where(bump, 0, vote)
        leader_c = torch.where(bump, 0, leader_id)
        ee_c = torch.where(bump, 0, ee)
        hb_c = torch.where(bump, 0, hb)
        rt_c = torch.where(bump, draw(term_c), rt)

        cand = req & (term == t_star)  # [P, G]

        # Vote decision per alive voter v; axes [c, v, G].
        lt_c, li_c = lt[:, None, :], li[:, None, :]
        lt_v, li_v = lt[None, :, :], li[None, :, :]
        up_to_date = (lt_c > lt_v) | ((lt_c == lt_v) & (li_c >= li_v))
        elig = cand[:, None, :] & up_to_date

        c_idx = torch.arange(P, dtype=I32, device=dev)[:, None, None]
        first_elig = torch.where(elig, c_idx, P).amin(0)  # [v, G]
        responder = alive & promotable & (term_c == t_star) & any_req
        can_vote = (vote_c == 0) & responder
        grant_to = torch.where(can_vote & (first_elig < P), first_elig, -1)
        granted_v = (grant_to[None, :, :] == c_idx) & (grant_to[None, :, :] >= 0)

        def tally(mask):
            grants = (granted_v & mask[None, :, :]).sum(1, dtype=I32)
            votes_for = grants + (cand & mask).to(I32)
            n = mask.sum(0, dtype=I32)
            q = n // 2 + 1
            resp = (responder & mask).sum(0, dtype=I32)
            missing = n - resp
            won_h = (votes_for >= q) | (n == 0)
            lost_h = (votes_for + missing < q) & (n > 0)
            return won_h, lost_h

        won_i, lost_i = tally(st.voter_mask)
        won_o, lost_o = tally(st.outgoing_mask)
        won = cand & won_i & won_o
        lost = cand & (lost_i | lost_o)
        winner_exists = won.any(0)  # [G]

        # Commit fast-forward via vote traffic, in the scalar pump's order.
        n_i = st.voter_mask.sum(0, dtype=I32)
        n_o = st.outgoing_mask.sum(0, dtype=I32)
        q_i = n_i // 2 + 1
        q_o = n_o // 2 + 1
        commit_run = commit
        cand_ff = torch.zeros_like(commit)
        for ci in range(P):
            c_active = cand[ci]
            c_req_commit = commit[ci]
            grants_ci = granted_v[ci]
            rej_ci = responder & ~grants_ci & (p_idx != ci) & c_active[None, :]
            agree_ci = st.agree[ci]
            cnt_i = (c_active & st.voter_mask[ci]).to(I32)
            cnt_o = (c_active & st.outgoing_mask[ci]).to(I32)
            rec_i, rec_o = cnt_i, cnt_o
            ff = torch.zeros((G,), dtype=I32, device=dev)
            for v in range(P):
                won_before = ((cnt_i >= q_i) | (n_i == 0)) & (
                    (cnt_o >= q_o) | (n_o == 0)
                )
                lost_before = (
                    (n_i > 0) & (cnt_i + (n_i - rec_i) < q_i)
                ) | ((n_o > 0) & (cnt_o + (n_o - rec_o) < q_o))
                snap = commit_run[v]
                ok = rej_ci[v] & ~won_before & ~lost_before & (snap <= agree_ci[v])
                ff = torch.where(ok, torch.maximum(ff, snap), ff)
                resp_v = grants_ci[v] | rej_ci[v]
                rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
                rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
                cnt_i = cnt_i + (grants_ci[v] & st.voter_mask[v]).to(I32)
                cnt_o = cnt_o + (grants_ci[v] & st.outgoing_mask[v]).to(I32)
            # A fresh plane with row ci replaced.
            cand_ff = cand_ff.clone()
            cand_ff[ci] = torch.maximum(cand_ff[ci], ff)
            vs_apply = (
                rej_ci
                & (state_c != ROLE_LEADER)
                & (c_req_commit[None, :] > commit_run)
                & (c_req_commit[None, :] <= agree_ci)
            )
            commit_run = torch.where(vs_apply, c_req_commit[None, :], commit_run)
        commit = torch.maximum(commit_run, cand_ff)

        vote_c = torch.where(grant_to >= 0, grant_to + 1, vote_c)
        ee_c = torch.where(grant_to >= 0, 0, ee_c)

        # Winner becomes leader and appends its noop; decided losers step down.
        li = torch.where(won, li + 1, li)
        lt = torch.where(won, t_star, lt)
        state_c = torch.where(won, ROLE_LEADER, state_c)
        leader_c = torch.where(won, self_id, leader_c)
        rt_c = torch.where(won, draw(term_c), rt_c)
        ee_c = torch.where(won, 0, ee_c)
        hb_c = torch.where(won, 0, hb_c)
        step_down = cand & ~won & (lost | (winner_exists & alive))
        state_c = torch.where(step_down, ROLE_FOLLOWER, state_c)
        rt_c = torch.where(step_down, draw(term_c), rt_c)
        ee_c = torch.where(step_down, 0, ee_c)

        matched = torch.where(won[:, None, :], 0, matched)
        ts = torch.where(won, li, ts)
        return (term_c, state_c, vote_c, leader_c, ee_c, hb_c, rt_c, li, lt,
                matched, ts, commit, winner_exists)

    def no_election(*planes):
        return planes + (torch.zeros((G,), dtype=torch.bool, device=dev),)

    planes = (term, state, vote, leader_id, ee, hb, rt, st.last_index,
              st.last_term, st.matched, st.term_start_index, st.commit)
    (term, state, vote, leader_id, ee, hb, rt, li, lt, matched, ts, commit,
     winner_exists) = (
        elect(*planes) if bool(req.any()) else no_election(*planes)
    )
    new_last_index, new_last_term, term_start, commit_c = li, lt, ts, commit

    # ---- Phase C': a crashed campaigner that is the sole voter of both
    # config halves wins locally.
    def _half_solo(mask):
        n = mask.sum(0, dtype=I32)
        return (n[None, :] == 0) | ((n[None, :] == 1) & mask)

    solo_win = (
        want_campaign
        & crashed
        & _half_solo(st.voter_mask)
        & _half_solo(st.outgoing_mask)
    )
    state = torch.where(solo_win, ROLE_LEADER, state)
    leader_id = torch.where(solo_win, self_id, leader_id)
    new_last_index = new_last_index + solo_win.to(I32)
    new_last_term = torch.where(solo_win, term, new_last_term)
    term_start = torch.where(solo_win, new_last_index, term_start)
    matched = torch.where(solo_win[:, None, :], 0, matched)
    eye = torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    matched = torch.where(
        solo_win[:, None, :] & eye, new_last_index[:, None, :], matched
    )
    commit_c = torch.where(solo_win, new_last_index, commit_c)
    hb = torch.where(solo_win, 0, hb)

    # ---- Phase D: replication round for groups with an alive leader.
    is_leader = (state == ROLE_LEADER) & alive
    has_leader = is_leader.any(0)
    lead_term = torch.where(is_leader, term, -1).amax(0)
    is_acting = is_leader & (term == lead_term)
    first_l = torch.where(is_acting, p_idx, P).amin(0)
    is_acting_leader = (p_idx == first_l) & has_leader

    n_app = torch.where(has_leader, append_n, 0)
    new_last_index = new_last_index + torch.where(is_acting_leader, n_app, 0)
    new_last_term = torch.where(is_acting_leader, lead_term, new_last_term)

    lead_last = torch.where(is_acting_leader, new_last_index, 0).amax(0)
    lead_last_term = torch.where(is_acting_leader, new_last_term, 0).amax(0)
    if lead is not None:
        lead.append((has_leader, first_l, lead_last, lead_term))

    lead_beat = (want_heartbeat & is_acting_leader).any(0)
    sent = has_leader & (lead_beat | (n_app > 0) | winner_exists)

    sync = sent & alive & member & (term <= lead_term) & ~is_acting_leader
    term_bumped = sync & (term < lead_term)
    term_d = torch.where(sync, lead_term, term)
    state_d = torch.where(sync, ROLE_FOLLOWER, state)
    vote_d = torch.where(term_bumped, 0, vote)
    leader_d = torch.where(sync, first_l + 1, leader_id)
    ee = torch.where(sync, 0, ee)
    rt = torch.where(term_bumped, draw(term_d), rt)
    new_last_index = torch.where(sync, lead_last, new_last_index)
    new_last_term = torch.where(sync, lead_last_term, new_last_term)

    acting_f = is_acting_leader.to(I32)
    in_s = sync | is_acting_leader
    agree_lead_row = _weighted_row(st.agree, acting_f)  # [P, G]: agree[l, b]
    agree = _merge_agree(st.agree, in_s, lead_last, agree_lead_row)
    acting_row = _weighted_row(matched, acting_f)  # [P_t, G]
    acting_row = torch.where(sync | is_acting_leader, new_last_index, acting_row)
    matched = torch.where(
        is_acting_leader[:, None, :], acting_row[None, :, :], matched
    )
    ts_acting = _weighted_row(term_start, acting_f)  # [G]

    # Quorum commit over both majorities, gated on the leader's own term.
    mci = torch.minimum(
        _quorum_index(acting_row, st.voter_mask),
        _quorum_index(acting_row, st.outgoing_mask),
    )
    commit_ok = has_leader & (mci >= ts_acting) & (mci < INF)
    lead_commit_old = torch.where(is_acting_leader, commit_c, 0).amax(0)
    lead_commit = torch.where(
        commit_ok, torch.maximum(lead_commit_old, mci), lead_commit_old
    )
    commit = torch.where(is_acting_leader, lead_commit, commit_c)
    commit = torch.where(sync, torch.maximum(commit, lead_commit), commit)

    out = State(
        term=term_d,
        state=state_d,
        vote=vote_d,
        leader_id=leader_d,
        election_elapsed=ee,
        heartbeat_elapsed=hb,
        randomized_timeout=rt,
        last_index=new_last_index,
        last_term=new_last_term,
        commit=commit,
        matched=matched,
        term_start_index=term_start,
        agree=agree,
        voter_mask=st.voter_mask,
        outgoing_mask=st.outgoing_mask,
        learner_mask=st.learner_mask,
    )
    return out


def _damped_linked_step(
    cfg: Config,
    st: State,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    link: torch.Tensor,  # bool[P, P, G]
    node_key: torch.Tensor,  # int64[P, G]
    lead: Optional[list] = None,
):
    """The damped (check-quorum / pre-vote) round over the directed
    delivery plane `link`, replayed wave by wave.

    It extends the undamped round's wave replay with the damping mechanisms,
    all in receipt order:

      tick      with check_quorum, each leader's election-timeout boundary
                reads and clears its recent_active row; without an active
                quorum it steps down and sends no heartbeat that round;
      lease     with check_quorum, a voter ignores a higher-term (pre-)vote
                request while leader_id != 0 and election_elapsed <
                election_tick at receipt (the running planes of the
                sender-ordered loops are receipt time);
      nudge     lower-term heartbeats and appends draw a response at the
                receiver's term, which deposes the stale sender in its
                response order: acks after the first such nudge are lost;
      pre-vote  campaigners probe at term + 1 without bumping anything;
                pre-winners run the real election two waves later, their
                vote requests interleaved with the catch-up appends.

    Acks, heartbeat responses and commit propagation set the owner's
    recent_active bits.  Each scan over senders (and over voters inside a
    tally) is a Python loop in sender order."""
    if st.recent_active is None:
        raise ValueError(
            "the damped round needs the recent_active plane; build the "
            "state with init_state(cfg)"
        )
    G, P = cfg.n_groups, cfg.n_peers
    cq, pv, et = cfg.check_quorum, cfg.pre_vote, cfg.election_tick
    dev = st.term.device
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    eye = torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    E = link & alive[:, None, :] & alive[None, :, :] & ~eye
    Erev = E.transpose(0, 1)  # Erev[s, v, g]: v -> s delivery
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)
    no = torch.zeros((P, G), dtype=torch.bool, device=dev)

    def draw(term):
        return timeout_draw(
            node_key, term.to(torch.int64) & 0xFFFFFFFF, lo, hi
        )

    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask
    ee, hb, want_campaign, want_heartbeat, want_cq = tick_kernel(
        st.state,
        st.election_elapsed,
        st.heartbeat_elapsed,
        st.randomized_timeout,
        promotable,
        cfg.election_tick,
        cfg.heartbeat_tick,
    )
    RA = st.recent_active
    state0, leader0 = st.state, st.leader_id

    # ---- the check-quorum boundary at tick time: read and clear the row;
    # without an active quorum the leader becomes a follower at its own
    # term and its heartbeat this round is suppressed.
    if cq:
        qa = check_quorum_active(RA, st.voter_mask, st.outgoing_mask)
        cq_dep = want_cq & ~qa
        RA = torch.where(want_cq[:, None, :], eye, RA)
        state0 = torch.where(cq_dep, ROLE_FOLLOWER, state0)
        leader0 = torch.where(cq_dep, 0, leader0)
        hb = torch.where(cq_dep, 0, hb)
        want_heartbeat = want_heartbeat & ~cq_dep
    # A kick goes through the ordinary damped machinery, a pre-vote probe
    # first with pre_vote, which keeps the clock (become_pre_candidate
    # touches only the role and leader_id); the transfer abort comes with
    # or without the check-quorum deposal.

    # ---- campaign local effects.  Real: term + 1, vote self, redraw.
    # Pre-vote: only the role and leader_id change; the request goes out
    # at term + 1.
    if pv:
        term = st.term
        state = torch.where(want_campaign, ROLE_PRE_CANDIDATE, state0)
        vote = st.vote
        leader_id = torch.where(want_campaign, 0, leader0)
        rt = st.randomized_timeout
        req_term = term + want_campaign.to(I32)
    else:
        term = st.term + want_campaign.to(I32)
        state = torch.where(want_campaign, ROLE_CANDIDATE, state0)
        vote = torch.where(want_campaign, self_id, st.vote)
        leader_id = torch.where(want_campaign, 0, leader0)
        rt = torch.where(want_campaign, draw(term), st.randomized_timeout)
        req_term = term
    req = want_campaign
    hb_send = want_heartbeat
    quorums = _half_quorums(st)

    def in_lease(Ld, EE):
        return (Ld != 0) & (EE < et) if cq else no

    def up_to_date(sid, LT, LI):
        lt_s = st.last_term[sid][None, :]
        return (lt_s > LT) | ((lt_s == LT) & (st.last_index[sid][None, :] >= LI))

    # ---- wave 1: heartbeats and (pre-)vote requests, per receiver in
    # sender order, with lease ignores and low-term nudges.
    T, V, Ld, St, EE, HB, RT, C = term, vote, leader_id, state, ee, hb, rt, st.commit
    grants, resps, snaps, resp_ts = [], [], [], []
    hb_accs, hb_ndg, hb_ndg_t = [], [], []
    for sid in range(P):
        d = E[sid]
        t_s = term[sid][None, :]
        h_del = d & hb_send[sid][None, :] & member
        h_bump = h_del & (t_s > T)
        h_acc = h_del & (t_s >= T)
        h_ndg = h_del & (t_s < T)  # the low-term nudge
        hb_ndg_t.append(torch.where(h_ndg, T, 0))
        T = torch.where(h_bump, t_s, T)
        V = torch.where(h_bump, 0, V)
        St = torch.where(h_acc, ROLE_FOLLOWER, St)
        Ld = torch.where(h_acc, sid + 1, Ld)
        EE = torch.where(h_acc, 0, EE)
        HB = torch.where(h_bump, 0, HB)
        RT = torch.where(h_bump, draw(T), RT)
        hb_val = torch.minimum(st.matched[sid], st.commit[sid][None, :])
        C = torch.where(h_acc, torch.maximum(C, hb_val), C)
        # (Pre-)vote request from s at its request term.
        rq = req_term[sid][None, :]
        c_s = st.commit[sid][None, :]
        r_del = d & req[sid][None, :] & promotable
        open_rq = r_del & ~(r_del & (rq > T) & in_lease(Ld, EE))
        up = up_to_date(sid, st.last_term, st.last_index)
        if pv:
            # No term bump, no vote record, no timer reset.
            at_hi = open_rq & (rq > T)
            at_eq = open_rq & (rq == T)
            g = (at_hi | (at_eq & ((V == sid + 1) | ((V == 0) & (Ld == 0))))) & up
            rej = (at_hi | at_eq) & ~g  # a reject with commit info
            snaps.append(torch.where(rej, C, 0))
            resps.append(g | rej | (open_rq & (rq < T)))
            resp_ts.append(torch.where(g, rq, T))
        else:
            bump = open_rq & (rq > T)
            T = torch.where(bump, rq, T)
            V = torch.where(bump, 0, V)
            Ld = torch.where(bump, 0, Ld)
            St = torch.where(bump, ROLE_FOLLOWER, St)
            EE = torch.where(bump, 0, EE)
            HB = torch.where(bump, 0, HB)
            RT = torch.where(bump, draw(T), RT)
            at = open_rq & (T == rq)
            g = at & (V == 0) & (Ld == 0) & up
            rej = at & ~g
            snaps.append(C)
            resps.append(at)
            V = torch.where(g, sid + 1, V)
            EE = torch.where(g, 0, EE)
        # Voter-side maybe_commit_by_vote off the request's commit info.
        vff = rej & (St != ROLE_LEADER) & (c_s > C) & (c_s <= st.agree[sid])
        C = torch.where(vff, c_s, C)
        grants.append(g)
        hb_accs.append(h_acc)
        hb_ndg.append(h_ndg)
    hb_accs, hb_ndg, hb_ndg_t = map(torch.stack, (hb_accs, hb_ndg, hb_ndg_t))

    # ---- wave 2a: heartbeat responses and nudges back at each leader, in
    # receiver order: the first nudge above the leader's term cuts off
    # every later response and deposes it at the largest nudge term.
    eff_hn = hb_ndg & Erev & (hb_ndg_t > T[:, None, :])
    resumed2 = (
        hb_accs
        & Erev
        & ~_cut_before(eff_hn, 1)
        & ((T == term) & (St == ROLE_LEADER))[:, None, :]
    )
    RA = RA | resumed2
    cu = resumed2 & (st.matched < st.last_index[:, None, :])
    hdep_t = torch.where(eff_hn, hb_ndg_t, 0).amax(1)
    hdep = eff_hn.any(1)
    T = torch.where(hdep, torch.maximum(T, hdep_t), T)
    V = torch.where(hdep, 0, V)
    St = torch.where(hdep, ROLE_FOLLOWER, St)
    Ld = torch.where(hdep, 0, Ld)
    EE = torch.where(hdep, 0, EE)
    HB = torch.where(hdep, 0, HB)
    RT = torch.where(hdep, draw(T), RT)

    if not pv:
        # ---- wave 2b: the real tally, as in _linked_step.
        C, won, lost = _real_tally(
            st, C, req & (St == ROLE_CANDIDATE), grants, resps, snaps, Erev,
            st.agree,
        )
        real_req = no
        rqt2 = req_term
    else:
        # ---- wave 2b: the pre-vote tally, responses in voter order.  A
        # reject above the candidate's current term deposes it (chainable),
        # a reject at its pre-campaign term records a poll rejection, grants
        # count while undecided; on a quorum the pre-winner campaigns for
        # real (term + 1, vote self, timers reset), its vote requests queued
        # for wave 3.
        pre_active = req & (St == ROLE_PRE_CANDIDATE)
        won_rows = []
        for sid in range(P):
            act = pre_active[sid]
            del_g = grants[sid] & Erev[sid]
            del_r = (resps[sid] & ~grants[sid]) & Erev[sid]
            t0 = term[sid]
            cnt_i = (act & st.voter_mask[sid]).to(I32)
            cnt_o = (act & st.outgoing_mask[sid]).to(I32)
            rec_i, rec_o = cnt_i, cnt_o
            won_f = act & _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)[0]
            lost_f = dep_f = torch.zeros_like(act)
            cur_t = torch.where(won_f, t0 + 1, t0)
            ff = torch.zeros_like(t0)
            for v in range(P):
                rt_v, snap_v = resp_ts[sid][v], snaps[sid][v]
                dep_now = del_r[v] & (rt_v > cur_t)
                undecided = ~dep_f & ~won_f & ~lost_f
                rec_grant = del_g[v] & undecided
                rec_rej = del_r[v] & (rt_v == t0) & undecided
                ok = rec_rej & (snap_v <= st.agree[sid][v])
                ff = torch.where(ok, torch.maximum(ff, snap_v), ff)
                cnt_i = cnt_i + (rec_grant & st.voter_mask[v]).to(I32)
                cnt_o = cnt_o + (rec_grant & st.outgoing_mask[v]).to(I32)
                resp_v = rec_grant | rec_rej
                rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
                rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
                won_v, lost_v = _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)
                won_now = rec_grant & won_v
                cur_t = torch.where(won_now, t0 + 1, cur_t)
                won_f = won_f | won_now
                lost_f = lost_f | (rec_rej & lost_v)
                dep_f = dep_f | dep_now
                cur_t = torch.where(dep_now, torch.maximum(cur_t, rt_v), cur_t)
            won_f, lost_f, dep_f = won_f & act, lost_f & act, dep_f & act
            # End-of-wave state of candidate row sid.
            C = _set_row(C, sid, torch.maximum(C[sid], ff))
            t_new = torch.where(act, cur_t, T[sid])
            win = won_f & ~dep_f
            v_new = torch.where(
                win, sid + 1, torch.where(dep_f & act & (cur_t != t0), 0, V[sid])
            )
            st_new = torch.where(
                win,
                ROLE_CANDIDATE,
                torch.where(dep_f | lost_f, ROLE_FOLLOWER, St[sid]),
            )
            settled = won_f | lost_f | dep_f
            rt_new = torch.where(
                won_f | dep_f,
                timeout_draw(
                    node_key[sid], t_new.to(torch.int64) & 0xFFFFFFFF,
                    lo[sid], hi[sid],
                ),
                RT[sid],
            )
            T = _set_row(T, sid, t_new)
            V = _set_row(V, sid, v_new)
            St = _set_row(St, sid, st_new)
            EE = _set_row(EE, sid, torch.where(settled, 0, EE[sid]))
            HB = _set_row(HB, sid, torch.where(settled, 0, HB[sid]))
            RT = _set_row(RT, sid, rt_new)
            won_rows.append(won_f)
        real_req = torch.stack(won_rows)  # broadcasts queued at win time
        rqt2 = term + 1

    # ---- after the real election (no pre-vote): winners become leaders
    # and append their noop; losers of a decided election step down.
    if not pv:
        li2 = st.last_index + won.to(I32)
        lt2 = torch.where(won, term, st.last_term)
        TS = torch.where(won, li2, st.term_start_index)
        St = torch.where(won, ROLE_LEADER, St)
        Ld = torch.where(won, self_id, Ld)
        RT = torch.where(won | lost, draw(T), RT)
        EE = torch.where(won | lost, 0, EE)
        HB = torch.where(won, 0, HB)
        St = torch.where(lost, ROLE_FOLLOWER, St)
        matched3 = torch.where(won[:, None, :], 0, st.matched)
        matched3 = torch.where(won[:, None, :] & eye, li2[:, None, :], matched3)
        RA = RA & ~won[:, None, :]
        noop_w3 = won
    else:
        li2, lt2 = st.last_index, st.last_term
        TS, matched3 = st.term_start_index, st.matched
        noop_w3 = won = no

    agree_run = st.agree
    LI, LT = li2, lt2
    C_send = C  # commit snapshots for the wave-3 sends

    def follow(msg, t, T, V, St, Ld, EE, HB, RT, sid):
        """A delivered message at term t that the receiver accepts."""
        bump = msg & (t > T)
        return (
            torch.where(msg, t, T),
            torch.where(bump, 0, V),
            torch.where(msg, ROLE_FOLLOWER, St),
            torch.where(msg, sid + 1, Ld),
            torch.where(msg, 0, EE),
            torch.where(bump, 0, HB),
            torch.where(bump, draw(torch.where(msg, t, T)), RT),
        )

    # ---- wave 3: appends (winner noops and catch-ups) and, with pre-vote,
    # the real vote requests, per receiver in sender order.  A probe that
    # does not match starts a retry chain, applied after the wave.
    ack3, ndg3, ndg3_t, retry3 = [], [], [], []
    r_grants, r_resps, r_snaps = [], [], []
    for sid in range(P):
        e_s, erev_s = E[sid], Erev[sid]
        agree_s = agree_run[sid]
        t_row = term[sid][None, :]
        dmask = e_s & member & (noop_w3[sid][None, :] | cu[sid])
        msg = dmask & (t_row >= T)
        ndg = dmask & (t_row < T)
        ndg3_t.append(torch.where(ndg, T, 0))
        # First-probe prev: a member never acked since this owner's
        # election probes from the noop, everyone else from the owner's
        # current last.
        prev_row = torch.where(
            matched3[sid] == 0, TS[sid][None, :] - 1, li2[sid][None, :]
        )
        probe_ok = agree_s >= prev_row
        retry3.append(msg & ~probe_ok & erev_s & ~_cut_before(ndg & erev_s, 0))
        adopt = msg & probe_ok
        T, V, St, Ld, EE, HB, RT = follow(msg, t_row, T, V, St, Ld, EE, HB, RT, sid)
        C = torch.where(adopt, torch.maximum(C, C_send[sid][None, :]), C)
        ack3.append(adopt & erev_s)
        ndg3.append(ndg)
        in_s = adopt | ((p_idx == sid) & adopt.any(0)[None, :])
        agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_s)
        LI = torch.where(adopt, li2[sid][None, :], LI)
        LT = torch.where(adopt, lt2[sid][None, :], LT)
        if pv:
            # The pre-winner's real vote request, after s's appends.
            rq = rqt2[sid][None, :]
            r_del = e_s & real_req[sid][None, :] & promotable
            open_rq = r_del & ~(r_del & (rq > T) & in_lease(Ld, EE))
            rbump = open_rq & (rq > T)
            T = torch.where(rbump, rq, T)
            V = torch.where(rbump, 0, V)
            Ld = torch.where(rbump, 0, Ld)
            St = torch.where(rbump, ROLE_FOLLOWER, St)
            EE = torch.where(rbump, 0, EE)
            HB = torch.where(rbump, 0, HB)
            RT = torch.where(rbump, draw(T), RT)
            at = open_rq & (T == rq)
            g = at & (V == 0) & (Ld == 0) & up_to_date(sid, LT, LI)
            rej = at & ~g
            r_snaps.append(C)
            rc = C_send[sid][None, :]
            vff = rej & (St != ROLE_LEADER) & (rc > C) & (rc <= agree_s)
            V = torch.where(g, sid + 1, V)
            EE = torch.where(g, 0, EE)
            C = torch.where(vff, rc, C)
            r_grants.append(g)
            r_resps.append(at)
    ack3, ndg3, ndg3_t, retry3 = map(torch.stack, (ack3, ndg3, ndg3_t, retry3))
    # A retry chain survives to the reject-processing wave only while its
    # sender is still the same-term leader.
    retry3_fire = retry3 & ((T == term) & (St == ROLE_LEADER))[:, None, :]

    def stage_fold(T, V, St, Ld, EE, HB, RT, RA, matched3, C, TS, ack, ndg,
                   ndg_t, sent_term, sent_idx):
        """The ack/nudge fold of waves 4 and 6: per sender, acks and nudges
        interleave in receiver order, the first effective nudge deposes it
        and drops every later ack; then each owner's quorum commit off its
        cut-off row."""
        eff_n = ndg & Erev & (ndg_t > T[:, None, :])
        was_lead = St == ROLE_LEADER
        ack_eff = (
            ack
            & ~_cut_before(eff_n, 1)
            & ((T == sent_term) & was_lead)[:, None, :]
        )
        matched3 = torch.where(
            ack_eff, torch.maximum(matched3, sent_idx[:, None, :]), matched3
        )
        RA = RA | ack_eff
        dep_t = torch.where(eff_n, ndg_t, 0).amax(1)
        dep = eff_n.any(1)
        T = torch.where(dep, torch.maximum(T, dep_t), T)
        V = torch.where(dep, 0, V)
        St = torch.where(dep, ROLE_FOLLOWER, St)
        Ld = torch.where(dep, 0, Ld)
        EE = torch.where(dep, 0, EE)
        HB = torch.where(dep, 0, HB)
        RT = torch.where(dep, draw(T), RT)
        rows = matched3.transpose(1, 2)  # [owner, G, target]
        mci = torch.minimum(
            committed_index(rows, st.voter_mask.t()[None].expand(P, G, P)),
            committed_index(rows, st.outgoing_mask.t()[None].expand(P, G, P)),
        )
        ok = was_lead & (mci >= TS) & (mci < INF)
        c_new = torch.where(ok, torch.maximum(C, mci), C)
        return T, V, St, Ld, EE, HB, RT, RA, matched3, c_new, c_new > C

    # ---- wave 4: the stage fold over the wave-3 acks; with pre-vote, the
    # real tally and its winner effects.
    T, V, St, Ld, EE, HB, RT, RA, matched3, C, adv = stage_fold(
        T, V, St, Ld, EE, HB, RT, RA, matched3, C, TS, ack3, ndg3, ndg3_t,
        term, li2,
    )
    if pv:
        C, won, lost = _real_tally(
            st, C, real_req & (St == ROLE_CANDIDATE), r_grants, r_resps,
            r_snaps, Erev, agree_run,
        )
        li2 = LI + won.to(I32)
        lt2 = torch.where(won, T, lt2)
        TS = torch.where(won, li2, TS)
        St = torch.where(won, ROLE_LEADER, St)
        Ld = torch.where(won, self_id, Ld)
        RT = torch.where(won | lost, draw(T), RT)
        EE = torch.where(won | lost, 0, EE)
        HB = torch.where(won, 0, HB)
        St = torch.where(lost, ROLE_FOLLOWER, St)
        matched3 = torch.where(won[:, None, :], 0, matched3)
        matched3 = torch.where(won[:, None, :] & eye, li2[:, None, :], matched3)
        RA = RA & ~won[:, None, :]
        LI = torch.where(won, li2, LI)
        LT = torch.where(won, lt2, LT)

    def apply_retry(fire, t_send, csend, St, Ld, EE, C, LI, LT, agree_run):
        """Retry resends (the maybe_decr chain) landing as wholesale
        adoption one wave after the reject, per sender in index order.  T
        is read-only: a resend is accepted only at an equal term."""
        acc_rows = []
        for sid in range(P):
            acc = fire[sid] & (t_send[sid][None, :] >= T)
            St = torch.where(acc, ROLE_FOLLOWER, St)
            Ld = torch.where(acc, sid + 1, Ld)
            EE = torch.where(acc, 0, EE)
            LI = torch.where(acc, li2[sid][None, :], LI)
            LT = torch.where(acc, lt2[sid][None, :], LT)
            C = torch.where(acc, torch.maximum(C, csend[sid][None, :]), C)
            in_s = acc | ((p_idx == sid) & acc.any(0)[None, :])
            agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_run[sid])
            acc_rows.append(acc)
        return torch.stack(acc_rows), St, Ld, EE, C, LI, LT, agree_run

    retry3_acc, St, Ld, EE, C, LI, LT, agree_run = apply_retry(
        retry3_fire, term, C_send, St, Ld, EE, C, LI, LT, agree_run
    )

    # ---- wave 5: commit-advance re-broadcasts and, with pre-vote, the
    # winners' noop broadcasts, one sender-ordered pass.  Re-broadcasts
    # carry prev = the leader's current last; a pre-vote winner's noop
    # carries its pre-noop cursor.
    C_send5 = C
    if pv:
        w5_prev = torch.where(won, li2 - 1, li2)
        w5_noop = won
        sent_term5 = torch.where(won, rqt2, term)
    else:
        w5_prev, w5_noop, sent_term5 = li2, no, term
    ack5, ndg5, ndg5_t, retry5 = [], [], [], []
    for sid in range(P):
        e_s, erev_s = E[sid], Erev[sid]
        agree_s = agree_run[sid]
        m3 = matched3[sid]
        t_row = sent_term5[sid][None, :]
        noop_d = e_s & member & w5_noop[sid][None, :]
        dmask = (e_s & member & adv[sid][None, :] & ((m3 > 0) | resumed2[sid])) | noop_d
        msg = dmask & (t_row >= T)
        ndg = dmask & (t_row < T)
        ndg5_t.append(torch.where(ndg, T, 0))
        prev_row = torch.where(m3 == 0, TS[sid][None, :] - 1, w5_prev[sid][None, :])
        probe_ok = agree_s >= prev_row
        retry5.append(msg & ~probe_ok & erev_s & ~_cut_before(ndg & erev_s, 0))
        adopt = msg & probe_ok
        T, V, St, Ld, EE, HB, RT = follow(msg, t_row, T, V, St, Ld, EE, HB, RT, sid)
        C = torch.where(adopt & noop_d, torch.maximum(C, C_send5[sid][None, :]), C)
        LI = torch.where(adopt, li2[sid][None, :], LI)
        LT = torch.where(adopt, lt2[sid][None, :], LT)
        ack5.append(adopt & erev_s)
        ndg5.append(ndg)
        in_s = adopt | ((p_idx == sid) & adopt.any(0)[None, :])
        agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_s)
    ack5, ndg5, ndg5_t, retry5 = map(torch.stack, (ack5, ndg5, ndg5_t, retry5))
    retry5_fire = retry5 & ((T == sent_term5) & (St == ROLE_LEADER))[:, None, :]
    retry5_acc, St, Ld, EE, C, LI, LT, agree_run = apply_retry(
        retry5_fire, sent_term5, torch.where(w5_noop, C_send5, 0), St, Ld,
        EE, C, LI, LT, agree_run,
    )
    ack5 = ack5 | retry3_acc | retry5_acc

    # ---- wave 6: the stage fold over the wave-5 acks, then the settled
    # commit propagated to in-sync sendable members, whose sends draw
    # nudges from higher-term receivers.
    T, V, St, Ld, EE, HB, RT, RA, matched3, C, _ = stage_fold(
        T, V, St, Ld, EE, HB, RT, RA, matched3, C, TS, ack5, ndg5, ndg5_t,
        sent_term5, li2,
    )
    # Against what each sender's appends carried: the wave-3 snapshot, or
    # the wave-5 one for a pre-vote winner's noop.
    csend6 = torch.where(won, C_send5, C_send) if pv else C_send
    send6 = (
        E
        & member
        & (St == ROLE_LEADER)[:, None, :]
        & ((matched3 > 0) | resumed2)
        & (C > csend6)[:, None, :]
    )
    elig6 = (
        send6
        & (sent_term5[:, None, :] >= T[None, :, :])
        & ((agree_run >= li2[:, None, :]) | Erev)
    )
    C = torch.maximum(C, torch.where(elig6, C[:, None, :], 0).amax(0))
    RA = RA | (elig6 & Erev)
    ndg6 = send6 & (sent_term5[:, None, :] < T[None, :, :]) & Erev
    dep6_t = torch.where(ndg6, T[None, :, :], 0).amax(1)
    dep6 = ndg6.any(1) & (dep6_t > T)
    T = torch.where(dep6, dep6_t, T)
    V = torch.where(dep6, 0, V)
    St = torch.where(dep6, ROLE_FOLLOWER, St)
    Ld = torch.where(dep6, 0, Ld)
    EE = torch.where(dep6, 0, EE)
    HB = torch.where(dep6, 0, HB)
    RT = torch.where(dep6, draw(T), RT)

    # ---- the round's append workload at the acting leader, with the same
    # nudge cutoffs on its ack stream.
    is_leader = (St == ROLE_LEADER) & alive
    has_leader = is_leader.any(0)
    lead_term = torch.where(is_leader, T, -1).amax(0)
    is_acting = is_leader & (T == lead_term)
    first_l = torch.where(is_acting, p_idx, P).amin(0)
    is_acting_leader = (p_idx == first_l) & has_leader
    n_app = torch.where(has_leader, append_n, 0)
    sent_b = has_leader & (n_app > 0)
    lead_pre_last = torch.where(is_acting_leader, LI, 0).amax(0)
    LI = LI + torch.where(is_acting_leader, n_app, 0)
    LT = torch.where(is_acting_leader & (n_app > 0), lead_term, LT)
    lead_last = torch.where(is_acting_leader, LI, 0).amax(0)
    lead_last_term = torch.where(is_acting_leader, LT, 0).amax(0)
    if lead is not None:
        lead.append((has_leader, first_l, lead_last, lead_term))
    reach_b = (E & is_acting_leader[:, None, :]).any(0)  # [P_v, G]
    ack_path = (E & is_acting_leader[None, :, :]).any(1)  # v -> l
    acting_f = is_acting_leader.to(I32)
    acting_row0 = _weighted_row(matched3, acting_f)
    resumed_act = (resumed2 & is_acting_leader[:, None, :]).any(0)
    agree_act = _weighted_row(agree_run, acting_f)
    pr_ok = (acting_row0 > 0) | resumed_act
    ts_acting = _weighted_row(TS, acting_f)
    send_w = sent_b & reach_b & member & ~is_acting_leader & pr_ok
    sync_msg = send_w & (T <= lead_term)
    ndg_w = send_w & (T > lead_term) & ack_path
    depw_t = torch.where(ndg_w, T, 0).amax(0)
    cutw = _cut_before(ndg_w, 0)
    # First-probe prev, or the surviving retry chain: the acting leader is
    # deposed only by these very nudges, so ~cutw is the survival gate.
    probe_w = agree_act >= torch.where(
        acting_row0 == 0, ts_acting[None, :] - 1, lead_pre_last[None, :]
    )
    sync_b = sync_msg & (probe_w | (ack_path & ~cutw))
    bump_b = sync_msg & (T < lead_term)
    T = torch.where(sync_msg, lead_term, T)
    St = torch.where(sync_msg, ROLE_FOLLOWER, St)
    V = torch.where(bump_b, 0, V)
    Ld = torch.where(sync_msg, first_l + 1, Ld)
    EE = torch.where(sync_msg, 0, EE)
    HB = torch.where(bump_b, 0, HB)
    RT = torch.where(bump_b, draw(T), RT)
    LI = torch.where(sync_b, lead_last, LI)
    LT = torch.where(sync_b, lead_last_term, LT)
    in_sb = sync_b | (is_acting_leader & sent_b)
    agree_run = _merge_agree(agree_run, in_sb, lead_last, agree_act)
    # The acting leader's ack stream, cut at the first workload nudge.
    ack_w = sync_b & ack_path & ~cutw
    acting_row = torch.where(
        ack_w | (is_acting_leader & sent_b),
        torch.maximum(acting_row0, lead_last),
        acting_row0,
    )
    matched3 = torch.where(
        is_acting_leader[:, None, :], acting_row[None, :, :], matched3
    )
    RA = RA | (is_acting_leader[:, None, :] & ack_w[None, :, :])
    mci_b = torch.minimum(
        _quorum_index(acting_row, st.voter_mask),
        _quorum_index(acting_row, st.outgoing_mask),
    )
    commit_ok = sent_b & (mci_b >= ts_acting) & (mci_b < INF)
    lead_commit_old = torch.where(is_acting_leader, C, 0).amax(0)
    lead_commit = torch.where(
        commit_ok, torch.maximum(lead_commit_old, mci_b), lead_commit_old
    )
    C = torch.where(is_acting_leader, lead_commit, C)
    C = torch.where(sync_b, torch.maximum(C, lead_commit), C)
    # Workload nudges depose the acting leader at round end.
    dw = is_acting_leader & (ndg_w.any(0) & (depw_t > lead_term))[None, :]
    T = torch.where(dw, depw_t[None, :], T)
    V = torch.where(dw, 0, V)
    St = torch.where(dw, ROLE_FOLLOWER, St)
    Ld = torch.where(dw, 0, Ld)
    EE = torch.where(dw, 0, EE)
    HB = torch.where(dw, 0, HB)
    RT = torch.where(dw, draw(T), RT)

    out = State(
        term=T,
        state=St,
        vote=V,
        leader_id=Ld,
        election_elapsed=EE,
        heartbeat_elapsed=HB,
        randomized_timeout=RT,
        last_index=LI,
        last_term=LT,
        commit=C,
        matched=matched3,
        term_start_index=TS,
        agree=agree_run,
        voter_mask=st.voter_mask,
        outgoing_mask=st.outgoing_mask,
        learner_mask=st.learner_mask,
        recent_active=RA,
    )
    return out
