"""ClusterSim in PyTorch: G Raft groups × P peers in peer-major [P, G]
tensors, advanced one lockstep protocol round at a time.

Counterpart of `raft_tpu/multiraft/sim.py`, reduced to what the main path
runs: `SimConfig` (:117), `SimState` (:226), `_node_key` (:511),
`init_state` (:528), `_sort_rows_desc` (:621), `_quorum_index` (:635), the
plain arm of `step` (:1209-1716: undamped, `link=None`, no extras) and
`ClusterSim` with `__init__`, `run_round` (:3950) and `run` (:4005).  The
round is the reference's round exactly, plane by plane: tick, campaign,
election resolution (vote grants, joint tallies, commit fast-forward via
vote traffic), the solo crashed-campaigner win, then replication and
quorum commit.

Options that this port does not implement yet raise NotImplementedError
instead of being ignored: the SimConfig flags `check_quorum`, `pre_vote`,
`transfer`, `lease_read`, `collect_counters`, `collect_health` and
`blackbox`, and the step arguments `group_ids`, `counters`, `health`,
`link`, `reconfig_propose`, `transfer_propose`, `campaign_kick`,
`read_propose` and `blackbox`.

The reference gates the election phase behind `lax.cond(any(req))`.
Here that is a host-side `if`, one device sync per general round; with
`SimConfig(spmd=True)` the phase runs unconditionally as masked ops (no
sync, some hundreds more small launches), which is bit-identical because
every write inside it is masked on this round's campaigners.

Tensors are never updated in place: every round returns fresh planes, like
the reference's pure step, so a caller may keep the previous state.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import kernels
from .kernels import ROLE_CANDIDATE, ROLE_FOLLOWER, ROLE_LEADER
from .platform import DeviceLike, resolve_device

I32 = torch.int32


class SimConfig(NamedTuple):
    """Static per-sim configuration; same fields, order and defaults as the
    reference's SimConfig.  Only the undamped, uninstrumented arm is
    implemented: see `check_supported`."""

    n_groups: int
    n_peers: int
    election_tick: int = 10
    heartbeat_tick: int = 1
    collect_counters: bool = False
    collect_health: bool = False
    health_window: int = 32
    leaderless_stall_ticks: int = 16
    commit_stall_ticks: int = 32
    churn_bumps: int = 4
    health_topk: int = 8
    check_quorum: bool = False
    pre_vote: bool = False
    transfer: bool = False
    lease_read: bool = False
    blackbox: bool = False
    blackbox_window: int = 8
    blackbox_topk: int = 8
    # Run the election phase unconditionally as masked ops instead of
    # behind a host-side `if any(campaigners)` (no device sync per round).
    spmd: bool = False

    @property
    def min_timeout(self) -> int:
        return self.election_tick

    @property
    def max_timeout(self) -> int:
        return 2 * self.election_tick


# SimConfig flags whose device paths are not ported yet.
_UNSUPPORTED_FLAGS = (
    "check_quorum",
    "pre_vote",
    "transfer",
    "lease_read",
    "collect_counters",
    "collect_health",
    "blackbox",
)


def check_supported(cfg: SimConfig, **extras) -> None:
    """Raise NotImplementedError if `cfg` sets a flag this port lacks, or
    if any of the optional arguments named in `extras` is given (not None)."""
    on = [f for f in _UNSUPPORTED_FLAGS if getattr(cfg, f)]
    if on:
        raise NotImplementedError(
            f"raft_tpu_torch does not implement SimConfig({', '.join(on)}) "
            "yet; only the undamped, uninstrumented step is ported"
        )
    given = [k for k, v in extras.items() if v is not None]
    if given:
        raise NotImplementedError(
            f"raft_tpu_torch does not implement {', '.join(given)} yet"
        )


class SimState(NamedTuple):
    """SoA state, peer-major [P, G] int32/bool; same fields and order as the
    reference's SimState.  `recent_active` and `transferee` belong to
    features not ported yet and are always None."""

    term: torch.Tensor  # int32[P, G]
    state: torch.Tensor  # int32[P, G] — ROLE_* codes
    vote: torch.Tensor  # int32[P, G] — 0 = none, else peer id (1..P)
    leader_id: torch.Tensor  # int32[P, G] — each peer's view; 0 = none
    election_elapsed: torch.Tensor  # int32[P, G]
    heartbeat_elapsed: torch.Tensor  # int32[P, G]
    randomized_timeout: torch.Tensor  # int32[P, G]
    last_index: torch.Tensor  # int32[P, G]
    last_term: torch.Tensor  # int32[P, G]
    commit: torch.Tensor  # int32[P, G]
    matched: torch.Tensor  # int32[P, P, G] — per-OWNER Progress.matched
    term_start_index: torch.Tensor  # int32[P, G] — owner's noop index
    agree: torch.Tensor  # int32[P, P, G] — pairwise common-prefix length
    voter_mask: torch.Tensor  # bool[P, G]
    outgoing_mask: torch.Tensor  # bool[P, G] — all False = not joint
    learner_mask: torch.Tensor  # bool[P, G]
    recent_active: Optional[torch.Tensor] = None
    transferee: Optional[torch.Tensor] = None


_BOOL_FIELDS = ("voter_mask", "outgoing_mask", "learner_mask")


def state_from_numpy(
    arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> SimState:
    """Build a SimState from numpy planes keyed by field name (bool planes
    to torch.bool, every other plane to torch.int32).  Absent or None
    optional planes stay None."""
    dev = resolve_device(device)
    fields = {}
    for name in SimState._fields:
        a = arrays.get(name)
        if a is None:
            fields[name] = None
            continue
        dtype = torch.bool if name in _BOOL_FIELDS else I32
        np_dtype = np.bool_ if dtype is torch.bool else np.int32
        # A copy: numpy views of other frameworks' buffers are read-only.
        fields[name] = torch.from_numpy(
            np.array(a, dtype=np_dtype, order="C", copy=True)
        ).to(dev)
    for name in ("recent_active", "transferee"):
        if fields[name] is not None:
            raise NotImplementedError(
                f"raft_tpu_torch does not implement the {name} plane yet"
            )
    return SimState(**fields)


def state_to_numpy(st: SimState) -> Dict[str, np.ndarray]:
    """The inverse of state_from_numpy: {field: numpy array} for every
    non-None plane."""
    return {
        name: getattr(st, name).cpu().numpy()
        for name in SimState._fields
        if getattr(st, name) is not None
    }


def _node_key(cfg: SimConfig, device: torch.device) -> torch.Tensor:
    """node_key[p, g] = g * 2**16 + (p + 1) mod 2**32 (the reference's
    uint32 arithmetic, which wraps for g >= 65536), as int64 words."""
    g = torch.arange(cfg.n_groups, dtype=torch.int64, device=device)[None, :]
    p = torch.arange(cfg.n_peers, dtype=torch.int64, device=device)[:, None]
    return (g * (1 << 16) + (p + 1)) & 0xFFFFFFFF


def init_state(
    cfg: SimConfig,
    voter_mask: Optional[torch.Tensor] = None,
    outgoing_mask: Optional[torch.Tensor] = None,
    learner_mask: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> SimState:
    """All peers start as followers at term 0 with their deterministic
    timeout draw (mirrors Raft.__init__ -> become_follower(0)).  Runs on
    `cuda` unless `device` says otherwise."""
    check_supported(cfg)
    dev = resolve_device(device)
    G, P = cfg.n_groups, cfg.n_peers
    shape = (P, G)

    def zeros():
        return torch.zeros(shape, dtype=I32, device=dev)

    def mask(m, fill):
        if m is None:
            return torch.full(shape, fill, dtype=torch.bool, device=dev)
        return m.to(device=dev, dtype=torch.bool)

    lo = torch.full(shape, cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full(shape, cfg.max_timeout, dtype=I32, device=dev)
    rt = kernels.timeout_draw(
        _node_key(cfg, dev), torch.zeros(shape, dtype=torch.int64, device=dev),
        lo, hi,
    )
    return SimState(
        term=zeros(),
        state=zeros(),
        vote=zeros(),
        leader_id=zeros(),
        election_elapsed=zeros(),
        heartbeat_elapsed=zeros(),
        randomized_timeout=rt,
        last_index=zeros(),
        last_term=zeros(),
        commit=zeros(),
        matched=torch.zeros((P, P, G), dtype=I32, device=dev),
        term_start_index=zeros(),
        agree=torch.zeros((P, P, G), dtype=I32, device=dev),
        voter_mask=mask(voter_mask, True),
        outgoing_mask=mask(outgoing_mask, False),
        learner_mask=mask(learner_mask, False),
    )


def _sort_rows_desc(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Descending odd-even transposition sorting network over P rows of [G]
    vectors (the reference's replacement for a sort along the peer axis)."""
    n = len(rows)
    rows = list(rows)
    for pass_ in range(n):
        for i in range(pass_ % 2, n - 1, 2):
            hi = torch.maximum(rows[i], rows[i + 1])
            lo = torch.minimum(rows[i], rows[i + 1])
            rows[i], rows[i + 1] = hi, lo
    return rows


def _quorum_index(matched: torch.Tensor, voter_mask: torch.Tensor) -> torch.Tensor:
    """Per-group majority commit index over the peer axis of [P, G] planes
    (reference: majority.rs:70-124); INF for an empty config.  int32[G]."""
    P = matched.shape[0]
    rows = _sort_rows_desc(
        [torch.where(voter_mask[p], matched[p], 0) for p in range(P)]
    )
    count = voter_mask.sum(0, dtype=I32)
    qpos = count // 2
    out = torch.zeros_like(rows[0])
    for p in range(P):
        out = torch.where(qpos == p, rows[p], out)
    return torch.where(count == 0, kernels.INF, out)


def _weighted_row(plane: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """sum over the owner axis of plane[o, ...] * f[o] in int32: the row of
    the one owner whose 0/1 weight f is set (zeros where none is)."""
    if plane.dim() == 3:
        f = f[:, None, :]
    return (plane * f).sum(0, dtype=I32)


def step(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    group_ids=None,
    counters=None,
    health=None,
    link=None,
    reconfig_propose=None,
    transfer_propose=None,
    campaign_kick=None,
    read_propose=None,
    blackbox=None,
) -> SimState:
    """One lockstep protocol round for every group (the reference step's
    plain arm).  crashed: bool[P, G] peers isolated this round (they keep
    ticking, exchange no messages); append_n: int32[G] entries proposed at
    each group's leader.  Returns the next SimState."""
    check_supported(
        cfg, group_ids=group_ids, counters=counters, health=health, link=link,
        reconfig_propose=reconfig_propose, transfer_propose=transfer_propose,
        campaign_kick=campaign_kick, read_propose=read_propose,
        blackbox=blackbox,
    )
    G, P = cfg.n_groups, cfg.n_peers
    dev = st.term.device
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    node_key = _node_key(cfg, dev)
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)

    def draw(term):
        return kernels.timeout_draw(
            node_key, term.to(torch.int64) & 0xFFFFFFFF, lo, hi
        )

    # ---- Phase A: tick every peer (crashed peers tick too).
    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask
    ee, hb, want_campaign, want_heartbeat, _ = kernels.tick_kernel(
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

    # ---- Phase C: election resolution among alive requesters.
    req = want_campaign & alive
    li, lt = st.last_index, st.last_term
    matched, ts, commit = st.matched, st.term_start_index, st.commit

    if cfg.spmd or bool(req.any()):
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
            # The reference's .at[ci].set: a fresh plane with row ci replaced.
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
        term, state, vote, leader_id = term_c, state_c, vote_c, leader_c
        ee, hb, rt = ee_c, hb_c, rt_c
    else:
        winner_exists = torch.zeros((G,), dtype=torch.bool, device=dev)
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
    agree = torch.where(
        in_s[:, None, :] & in_s[None, :, :],
        lead_last[None, None, :],
        torch.where(
            in_s[:, None, :],
            agree_lead_row[None, :, :],
            torch.where(in_s[None, :, :], agree_lead_row[:, None, :], st.agree),
        ),
    )
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
    commit_ok = has_leader & (mci >= ts_acting) & (mci < kernels.INF)
    lead_commit_old = torch.where(is_acting_leader, commit_c, 0).amax(0)
    lead_commit = torch.where(
        commit_ok, torch.maximum(lead_commit_old, mci), lead_commit_old
    )
    commit = torch.where(is_acting_leader, lead_commit, commit_c)
    commit = torch.where(sync, torch.maximum(commit, lead_commit), commit)

    return SimState(
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


class ClusterSim:
    """Host-side runner over `step`: holds the state and advances it one
    round per `run_round`.  Planes are peer-major [P, G] on `device`
    (`cuda` unless the caller asks for the CPU)."""

    def __init__(
        self,
        cfg: SimConfig,
        voter_mask: Optional[torch.Tensor] = None,
        outgoing_mask: Optional[torch.Tensor] = None,
        learner_mask: Optional[torch.Tensor] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(
            cfg, voter_mask, outgoing_mask, learner_mask, device=self.device
        )

    def run_round(self, crashed=None, append_n=None) -> SimState:
        """One protocol round; crashed bool[P, G] and append_n int32[G]
        default to no crashes and no appends."""
        G, P = self.cfg.n_groups, self.cfg.n_peers
        if crashed is None:
            crashed = torch.zeros((P, G), dtype=torch.bool, device=self.device)
        if append_n is None:
            append_n = torch.zeros((G,), dtype=I32, device=self.device)
        crashed = crashed.to(device=self.device, dtype=torch.bool)
        append_n = append_n.to(device=self.device, dtype=I32)
        self.state = step(self.cfg, self.state, crashed, append_n)
        return self.state

    def run(self, rounds: int, crashed=None, append_n=None) -> SimState:
        for _ in range(rounds):
            self.run_round(crashed, append_n)
        return self.state
