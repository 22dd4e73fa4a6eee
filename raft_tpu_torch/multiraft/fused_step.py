"""The steady-state dispatcher: run k protocol rounds on the fused kernel
when the steady invariant provably holds for all of them, else k general
steps.  Both branches give the same state, bit for bit.

Counterpart of `raft_tpu/multiraft/pallas_step.py`: `steady_mask`
(:1355-1554, the defuse, the plain, the link, the damped, the transferee,
the reconfig and the read arm), `steady_predicate` (:1557), `steady_round` with its host wrapper
`_run` (:549-749), `steady_round(with_chaos=True)` with its host wrapper
`_build_chaos_round._run` (:806-886) as `chaos_round` here, the damped
configs' `_build_damped_round._run` (:1240-1352, plain and with chaos) as
`damped_round`, the closed-form instrumentation folds `_fold_counters`
(:505) and `_steady_health_fold` (:530), the one-round dispatcher
`fast_step` (:1572-1600), `fast_multi_round` (:1605-1782,
every arm, with `count_fused`) and the per-group split
`hybrid_multi_round` (:1785-1952, with `with_chaos` and `count_fused`).
As in the reference, a damped config (check_quorum or pre_vote) routes
every fused block to the damped kernel, and every fused round takes the
counters and health extras after its other arguments, counters first:
`with_health` runs the kernel's with_health variant, which carries
ticks_since_commit.

The reference's `lax.cond` on the predicate becomes a host `bool(pred)`
(in hybrid_multi_round, an `int` of the storm count): one device sync per
k-round block.  On CUDA tensors without a link plane the predicate is one
hand-written kernel (predicate_kernel: a set and a launch, where the plain
composition, steady_mask_reference, is 29 to 87 launches).  On a rank of
a mesh run (cfg.shard set) the predicate and the storm count are reduced
over every rank first (sharding.all_ranks, sharding.sum_ranks), so all
ranks take the arm that the reference's predicate over the whole batch
takes, and the fused kernels key their loss draws on the rank's global
group ids.  The gathers of the acting
leader's rows before the kernel and the scatters after it (and, on the
plain path, the `agree` update) stay plain PyTorch, as the reference
leaves them to XLA; at 100k groups × 5 peers they move more bytes than the
steady kernel itself.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import profiling
from . import sharding
from . import sim as sim_mod
from . import kernels
from . import predicate_kernel
from .chaos_kernel import MAX_PEERS, chaos_rounds, check_round_base
from .damped_kernel import damped_rounds
from .kernels import (
    CTR_COMMIT_ENTRIES,
    CTR_HEARTBEATS,
    HP_SINCE_COMMIT,
    HP_TERM_BUMPS,
    HP_VOTE_SPLITS,
    ROLE_LEADER,
    link_loss_draw,
)
from .platform import DeviceLike, resolve_device
from .sim import HealthState, SimConfig, SimState
from .steady_kernel import steady_rounds

I32 = torch.int32


def steady_mask(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,
    horizon: int = 1,
    link=None,
    reconfig_pending=None,
    loss_rate=None,
    read_pending=None,
) -> torch.Tensor:
    """bool[G]: per-group steady invariant for the next `horizon` rounds —
    no election timer can fire, exactly one alive leader, every alive peer
    already at the leader's term, not in joint config, no leader transfer
    pending anywhere in the group (with a transferee plane), with
    `reconfig_pending` (bool[G], reconfig.pending_in_horizon) no conf
    change in flight or due inside the horizon, and with `read_pending`
    (bool[G], workload.reads_pending_in_horizon) no quorum-round read work
    inside it (lease fires stay fusable; the caller folds them).

    With `link` (the bool[P, P, G] reachability plane) every directed link
    among alive peers must also be up, and the election-timer bound is the
    free-running one: per-link loss may drop any heartbeat, so the
    per-round re-sync cannot be relied on.

    A damped config (check_quorum or pre_vote) always takes the
    free-running bound, which keeps pre-vote and the low-term nudge
    provably dormant, and rejects every group when election_tick <=
    heartbeat_tick.  With check_quorum every leader boundary inside the
    horizon must provably pass: without `link`, kernels.cq_boundary_safe;
    with `link` and `loss_rate` (int32[P, P, G]), the same per group, the
    groups with a nonzero rate anywhere held to the no-boundary bound; with
    `link` alone, no role-leader may reach its boundary.

    A black-box config (SimConfig.blackbox) rejects every group: the fused
    kernels cannot fold the per-round ring record, so such configs run the
    general rounds.

    On CUDA tensors without `link` this is one hand-written kernel
    (predicate_kernel.steady_invariant); steady_mask_reference, its plain
    version, runs on the CPU and for the link arms."""
    if link is None and st.term.is_cuda:
        return predicate_kernel.steady_invariant(
            cfg, st, crashed, horizon, reconfig_pending, read_pending)
    return steady_mask_reference(cfg, st, crashed, horizon, link,
                                 reconfig_pending, loss_rate, read_pending)


def steady_mask_reference(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,
    horizon: int = 1,
    link=None,
    reconfig_pending=None,
    loss_rate=None,
    read_pending=None,
) -> torch.Tensor:
    """steady_mask as plain tensor code on any device: the readable
    statement of the invariant that the kernel is held to."""
    if cfg.blackbox:
        return torch.zeros((cfg.n_groups,), dtype=torch.bool, device=st.term.device)
    damped = cfg.check_quorum or cfg.pre_vote
    if damped and cfg.election_tick <= cfg.heartbeat_tick:
        # The saturation argument needs a full heartbeat interval strictly
        # inside each boundary window.
        return torch.zeros((cfg.n_groups,), dtype=torch.bool, device=st.term.device)
    alive = ~crashed
    # 1. nobody can campaign within the horizon.  With heartbeat_tick == 1
    # and no link plane, an alive follower under a live leader is re-synced
    # every round, so only its first tick uses the current ee; crashed
    # peers' timers run free.  Otherwise the free-running bound holds for
    # all.
    non_leader_voter = (st.state != ROLE_LEADER) & st.voter_mask
    if cfg.heartbeat_tick == 1 and link is None and not damped:
        elapsed = torch.where(
            alive, st.election_elapsed + 1, st.election_elapsed + horizon
        )
    else:
        elapsed = st.election_elapsed + horizon
    may_fire = non_leader_voter & (elapsed >= st.randomized_timeout)
    no_campaign = ~may_fire.any(0)
    # 2. exactly one alive leader per group
    is_leader = (st.state == ROLE_LEADER) & alive
    one_leader = is_leader.sum(0, dtype=I32) == 1
    # 3. alive peers at the leader's term
    lead_term = torch.where(is_leader, st.term, 0).amax(0)
    terms_ok = torch.where(alive, st.term == lead_term, True).all(0)
    # 4. not joint
    not_joint = ~st.outgoing_mask.any(0)
    ok = no_campaign & one_leader & terms_ok & not_joint
    if st.transferee is not None:
        # 4a. no pending leader transfer: the fused kernel can neither pump
        # the catch-up / MsgTimeoutNow protocol nor drop proposals behind
        # it.  The plane rides through a fused block untouched (it is
        # provably all-zero there).
        ok = ok & ~(st.transferee > 0).any(0)
    if reconfig_pending is not None:
        # 4b. no conf change is in flight or due inside the horizon.
        ok = ok & ~reconfig_pending
    if read_pending is not None:
        # 4c. no quorum-round read work touches the horizon.
        ok = ok & ~read_pending
    if link is not None:
        # 5. every directed link among alive peers is up.
        eye = torch.eye(cfg.n_peers, dtype=torch.bool, device=link.device)
        links_ok = (
            link | eye[:, :, None] | crashed[:, None, :] | crashed[None, :, :]
        ).all(1).all(0)
        ok = ok & links_ok
    if cfg.check_quorum:
        # 6. every check-quorum boundary inside the horizon passes.
        if st.recent_active is None:
            raise predicate_kernel.missing_recent_active()
        bound = (
            st.recent_active, st.voter_mask, st.outgoing_mask, st.state,
            crashed, st.election_elapsed, horizon, cfg.election_tick,
        )
        if link is None:
            ok = ok & kernels.cq_boundary_safe(*bound)
        elif loss_rate is not None:
            lossy = (loss_rate != 0).any(0).any(0)
            ok = ok & kernels.cq_boundary_safe(*bound, lossy=lossy)
        else:
            ok = ok & torch.where(
                st.state == ROLE_LEADER,
                st.election_elapsed + horizon < cfg.election_tick,
                True,
            ).all(0)
    return ok


def steady_predicate(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,
    horizon: int = 1,
    link=None,
    loss_rate=None,
) -> torch.Tensor:
    """0-dim bool tensor: True iff every group satisfies the steady
    invariant (see steady_mask).  On CUDA tensors without `link` one
    kernel reduces it, at most two device operations."""
    if link is None and st.term.is_cuda:
        return predicate_kernel.steady_invariant(cfg, st, crashed, horizon,
                                                 whole=True)
    return steady_mask(cfg, st, crashed, horizon, link, loss_rate=loss_rate).all()


def _leader_flag(st: SimState, crashed: torch.Tensor) -> torch.Tensor:
    """int32[P, G], 1 at each group's acting leader (alive, role leader).
    It is fixed for the whole steady horizon, so the kernels' leader
    operands are gathered once before the call."""
    return ((st.state == ROLE_LEADER) & ~crashed).to(I32)


def _gather(plane: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """The acting leader's slice of a plane: [P, G] -> [G], [P, P, G] ->
    [P, G] (its tracker row)."""
    f = flag if plane.dim() == 2 else flag[:, None, :]
    return (plane * f).sum(0, dtype=I32)


def _scatter_matched(st: SimState, flag: torch.Tensor, row: torch.Tensor):
    """st.matched with the acting leader's tracker row replaced by `row`."""
    return torch.where(flag[:, None, :] != 0, row[None, :, :], st.matched)


def steady_operands(
    st: SimState, crashed: torch.Tensor, append_n: torch.Tensor, tsc=None
):
    """The steady kernel's operands (steady_rounds' positional arguments):
    the planes, the acting leader's tracker row and its term start, and
    `tsc` (the with_health variant's ticks_since_commit row) when given."""
    f = _leader_flag(st, crashed)
    return (
        st.state, st.term, st.election_elapsed, st.heartbeat_elapsed,
        st.last_index, st.last_term, _gather(st.matched, f), st.commit,
        st.voter_mask, st.voter_mask | st.learner_mask, crashed,
        _gather(st.term_start_index, f), append_n,
    ) + (() if tsc is None else (tsc,))


def chaos_operands(
    st: SimState, crashed: torch.Tensor, append_n: torch.Tensor,
    loss_rate: torch.Tensor, tsc=None,
):
    """The chaos kernel's operands (chaos_rounds' positional arguments):
    the planes as they are (the reference packs roles and masks into words;
    the kernel takes them unpacked), the acting leader's tracker row, term
    start and term, and `tsc` when given."""
    f = _leader_flag(st, crashed)
    return (
        st.state, st.leader_id, st.heartbeat_elapsed, st.election_elapsed,
        st.last_index, st.last_term, st.commit, _gather(st.matched, f),
        st.voter_mask, st.voter_mask | st.learner_mask, crashed, st.agree,
        loss_rate, _gather(st.term_start_index, f), _gather(st.term, f),
        append_n,
    ) + (() if tsc is None else (tsc,))


def damped_operands(
    st: SimState, crashed: torch.Tensor, append_n: torch.Tensor,
    loss_rate=None, tsc=None,
):
    """The damped kernel's operands (damped_rounds' positional arguments):
    the planes as they are, the acting leader's tracker row, its
    recent_active row, term start and term, `loss_rate` or None, and `tsc`
    when given."""
    if st.recent_active is None:
        raise ValueError(
            "the fused damped round needs the recent_active plane but the "
            "state has None; rebuild it with init_state(cfg)"
        )
    f = _leader_flag(st, crashed)
    ra_row = (st.recent_active & (f != 0)[:, None, :]).any(0)
    return (
        st.state, st.leader_id, st.heartbeat_elapsed, st.election_elapsed,
        st.last_index, st.last_term, st.commit, _gather(st.matched, f),
        ra_row, st.voter_mask, st.voter_mask | st.learner_mask, crashed,
        st.agree, loss_rate, _gather(st.term_start_index, f),
        _gather(st.term, f), append_n,
    ) + (() if tsc is None else (tsc,))


def _ticks(cfg: SimConfig, rounds: int) -> dict:
    return dict(rounds=rounds, election_tick=cfg.election_tick,
                heartbeat_tick=cfg.heartbeat_tick)


def _fold_counters(cfg: SimConfig, k: int, st_in: SimState, st_out: SimState,
                   counters: torch.Tensor) -> torch.Tensor:
    """Closed-form counter fold over a steady k-round horizon: no campaign
    and no election (the predicate forbids both), (hb0 + k) //
    heartbeat_tick heartbeat fires per role-leader (the timer resets on
    every fire), and the commit deltas telescope because commit is
    monotone; equal to threading the counters through k sim.steps."""
    role_leader = st_in.state == ROLE_LEADER
    fires = torch.where(
        role_leader, (st_in.heartbeat_elapsed + k) // cfg.heartbeat_tick, 0
    )
    bump = torch.zeros_like(counters)
    bump[CTR_HEARTBEATS] = fires.sum(dtype=I32)
    bump[CTR_COMMIT_ENTRIES] = (st_out.commit - st_in.commit).sum(dtype=I32)
    return counters + bump


def _steady_health_fold(
    cfg: SimConfig, rounds: int, health: HealthState, tsc_out: torch.Tensor
) -> HealthState:
    """Closed-form health fold over a steady horizon: a leader held all
    rounds (leaderless 0), ticks_since_commit is the kernel's, the churn
    window resets iff a round with window_pos == 0 falls inside [pos, pos +
    rounds) and every in-horizon term bump is 0, and no vote split
    happened."""
    pos = health.window_pos
    crossed = pos == 0 or pos + rounds > cfg.health_window
    bumps = health.planes[HP_TERM_BUMPS]
    planes = torch.stack([
        torch.zeros_like(tsc_out),
        tsc_out,
        torch.zeros_like(bumps) if crossed else bumps,
        health.planes[HP_VOTE_SPLITS],
    ])
    return HealthState(planes, (pos + rounds) % cfg.health_window)


def _instrumented(cfg: SimConfig, rounds: int, run, n_lead: int,
                  with_counters: bool, with_health: bool):
    """fn(st, crashed, append_n, *lead, [counters], [health]) around
    run(st, crashed, append_n, *lead, tsc) -> (SimState, tsc'): the
    reference's extras layout.  It returns the SimState alone without
    extras, else (SimState, counters', health') for the extras it takes;
    with `with_health` the kernel gets the ticks_since_commit row."""

    def fn(st: SimState, crashed: torch.Tensor, append_n: torch.Tensor, *rest):
        lead, extras = rest[:n_lead], rest[n_lead:]
        if len(extras) != with_counters + with_health:
            raise TypeError(
                f"expected {n_lead} arguments after append_n, then "
                f"{'counters ' if with_counters else ''}"
                f"{'health' if with_health else ''}; got {len(rest)}"
            )
        health = extras[-1] if with_health else None
        tsc = None if health is None else health.planes[HP_SINCE_COMMIT]
        out, tsc_out = run(st, crashed, append_n, *lead, tsc)
        if not (with_counters or with_health):
            return out
        res = (out,)
        if with_counters:
            res += (_fold_counters(cfg, rounds, st, out, extras[0]),)
        if with_health:
            res += (_steady_health_fold(cfg, rounds, health, tsc_out),)
        return res

    return fn


def steady_round(
    cfg: SimConfig, rounds: int = 1, with_health: bool = False,
    with_counters: bool = False,
) -> Callable:
    """fn(st, crashed, append_n) -> SimState advancing `rounds` fused steady
    rounds (same crashed/append each round).  Valid only where
    steady_predicate(cfg, st, crashed, horizon=rounds) holds.  With
    `with_counters` and/or `with_health` the fn takes the [N_COUNTERS]
    int32 plane and/or the HealthState after append_n, in that order, and
    returns (SimState, counters', health'), equal to threading them through
    `rounds` sim.steps.  A damped config gets damped_round(cfg, rounds)."""
    if cfg.check_quorum or cfg.pre_vote:
        return damped_round(cfg, rounds, with_health=with_health,
                            with_counters=with_counters)
    ticks = _ticks(cfg, rounds)

    @profiling.phased
    def run(st, crashed, append_n, tsc):
        ph = profiling.phases()
        ph("fused.operands")
        operands = steady_operands(st, crashed, append_n, tsc)
        ph("fused.kernel")
        ee, hb, li, lt, new_row, commit, *tsc_out = steady_rounds(*operands, **ticks)
        del operands  # the gathered rows go before the merge's temporaries
        ph("fused.merge")
        f = _leader_flag(st, crashed)
        is_leader = f != 0
        # Pairwise log agreement, applied once for the whole horizon (the
        # sync set is constant while steady; only the final last index
        # of the leader matters).
        member = st.voter_mask | st.learner_mask
        in_s = (member & ~crashed) | is_leader
        lead_last = torch.where(is_leader, li, 0).amax(0)  # [G]
        agree = sim_mod._merge_agree(st.agree, in_s, lead_last, _gather(st.agree, f))
        out = st._replace(
            election_elapsed=ee,
            heartbeat_elapsed=hb,
            last_index=li,
            last_term=lt,
            matched=_scatter_matched(st, f, new_row),
            commit=commit,
            agree=agree,
        )
        return out, (tsc_out[0] if tsc_out else None)

    return _instrumented(cfg, rounds, run, 0, with_counters, with_health)


def _check_packed_peers(cfg: SimConfig, name: str) -> None:
    """The reference's chaos and damped builders assert P <= 15
    (pallas_step.py:772, :1203); the same limit, as a ValueError."""
    if cfg.n_peers > MAX_PEERS:
        raise ValueError(
            f"{name}: P={cfg.n_peers} > {MAX_PEERS}: the reference's packed "
            "roles word budgets 4 bits for leader_id"
        )


def chaos_round(
    cfg: SimConfig, rounds: int = 1, with_health: bool = False,
    with_counters: bool = False,
) -> Callable:
    """The reference's steady_round(with_chaos=True): fn(st, crashed,
    append_n, loss_rate, round_base) -> SimState advancing `rounds` fused
    loss-gated steady rounds.  loss_rate is the int32[P, P, G] per-link
    rate, round_base (a Python int) the absolute index of the first round,
    and the result equals `rounds` steps of sim.step(link=healed &
    ~link_loss_draw(round, loss_rate)).  The counters and health extras
    follow round_base, as in steady_round.  Valid where the predicate holds
    with a healed link plane.  A damped config gets damped_round(cfg,
    rounds, with_chaos=True)."""
    if cfg.check_quorum or cfg.pre_vote:
        return damped_round(cfg, rounds, with_chaos=True, with_health=with_health,
                            with_counters=with_counters)
    _check_packed_peers(cfg, "chaos_round")
    ticks = _ticks(cfg, rounds)

    @profiling.phased
    def run(st, crashed, append_n, loss_rate, round_base, tsc):
        ph = profiling.phases()
        ph("fused.operands")
        operands = chaos_operands(st, crashed, append_n, loss_rate, tsc)
        ph("fused.kernel")
        (state, leader_id, hb, ee, li, lt, commit, new_row, agree,
         *tsc_out) = chaos_rounds(
            *operands, round_base=round_base, group_base=sim_mod.group_base(cfg),
            **ticks,
        )
        del operands  # the gathered rows go before the merge's temporaries
        ph("fused.merge")
        out = st._replace(
            state=state,
            leader_id=leader_id,
            election_elapsed=ee,
            heartbeat_elapsed=hb,
            last_index=li,
            last_term=lt,
            matched=_scatter_matched(st, _leader_flag(st, crashed), new_row),
            commit=commit,
            agree=agree,
        )
        return out, (tsc_out[0] if tsc_out else None)

    return _instrumented(cfg, rounds, run, 2, with_counters, with_health)


def damped_round(
    cfg: SimConfig, rounds: int = 1, with_chaos: bool = False,
    with_health: bool = False, with_counters: bool = False,
) -> Callable:
    """The reference's steady_round for a damped config: fn(st, crashed,
    append_n) -> SimState advancing `rounds` fused damped rounds, equal to
    `rounds` damped sim.steps; with `with_chaos`, fn(st, crashed, append_n,
    loss_rate, round_base) as chaos_round; the counters and health extras
    follow, as in steady_round.  The kernel's matched and recent_active
    rows go back to the acting leader only: the rows of crashed stale
    leaders stay as they are, as the general rounds leave them.  Valid
    where the predicate holds (with a healed link plane and `loss_rate`
    when chaos is on)."""
    if not (cfg.check_quorum or cfg.pre_vote):
        raise ValueError("damped_round needs check_quorum or pre_vote")
    _check_packed_peers(cfg, "damped_round")
    ticks = dict(_ticks(cfg, rounds), with_cq=cfg.check_quorum)

    @profiling.phased
    def run(st, crashed, append_n, *rest):
        *lead, tsc = rest
        loss_rate, round_base = lead if with_chaos else (None, 0)
        ph = profiling.phases()
        ph("fused.operands")
        operands = damped_operands(st, crashed, append_n, loss_rate, tsc)
        ph("fused.kernel")
        (state, leader_id, hb, ee, li, lt, commit, new_row, ra, agree,
         *tsc_out) = damped_rounds(
            *operands, round_base=round_base, group_base=sim_mod.group_base(cfg),
            **ticks,
        )
        del operands  # the gathered rows go before the merge's temporaries
        ph("fused.merge")
        f = _leader_flag(st, crashed)
        out = st._replace(
            state=state,
            leader_id=leader_id,
            election_elapsed=ee,
            heartbeat_elapsed=hb,
            last_index=li,
            last_term=lt,
            matched=_scatter_matched(st, f, new_row),
            commit=commit,
            agree=agree,
            recent_active=torch.where(
                f[:, None, :] != 0, ra[None, :, :], st.recent_active
            ),
        )
        return out, (tsc_out[0] if tsc_out else None)

    return _instrumented(cfg, rounds, run, 2 if with_chaos else 0,
                         with_counters, with_health)


def fast_step(cfg: SimConfig, with_health: bool = False) -> Callable:
    """Dispatcher for one round (`pallas_step.fast_step`): the fused round
    at rounds=1 when steady_predicate holds at horizon 1, else the general
    sim.step.  fn(st, crashed, append_n) -> SimState, as sim.step; with
    `with_health`, fn(st, crashed, append_n, health) -> (SimState,
    HealthState).  The reference's `lax.cond` is a host branch here, one
    device sync a round; on CUDA tensors the fused arm of a plain config
    launches csrc/steady_round.cu with k = 1."""
    fused_fn = steady_round(cfg, 1, with_health=with_health)

    def fn(st: SimState, crashed, append_n, *health):
        if len(health) != int(with_health):
            raise TypeError(f"expected {int(with_health)} extras, got {len(health)}")
        with profiling.annotate("dispatch.predicate"):
            pred = steady_predicate(cfg, st, crashed, horizon=1)
        with profiling.annotate("dispatch.wait"):
            pred = sharding.all_ranks(cfg, pred)
        if pred:
            return fused_fn(st, crashed, append_n, *health)
        kw = {"health": health[0]} if with_health else {}
        return sim_mod.step(cfg, st, crashed, append_n, **kw)

    return fn


def fast_multi_round(
    cfg: SimConfig, k: int = 16, with_chaos: bool = False,
    count_fused: bool = False, with_health: bool = False,
    with_counters: bool = False,
):
    """Dispatcher advancing k protocol rounds per call (same crashed/append
    every round): the fused kernel when provably steady for the whole
    horizon, else k sequential general steps.  Semantically identical to
    calling sim.step k times.

    fn(st, crashed, append_n) -> SimState.  With `with_chaos`,
    fn(st, crashed, append_n, link, loss_rate, round_base): the link plane
    and the int32[P, P, G] per-link loss rates are the fault surface and
    round_base (a Python int) the absolute index of the first of the k
    rounds, the loss PRNG's replay key; the general branch runs k steps of
    sim.step(link=link & ~link_loss_draw(round_base + r, loss_rate)), and
    every round index must lie in int32.  A damped config runs
    damped_round on its fused branch and damped sim.steps on the other.

    With `with_counters` and/or `with_health`, fn takes the [N_COUNTERS]
    int32 plane and/or the HealthState next, in that order, both branches
    thread them, and it returns (SimState, counters', health').

    With `count_fused`, fn takes one more argument last, the fused
    group-round count so far (a Python int), and returns it last,
    increased by k * n_groups if the fused branch ran."""
    fused_fn = (chaos_round if with_chaos else steady_round)(
        cfg, k, with_health=with_health, with_counters=with_counters
    )
    n_extra = int(with_counters) + int(with_health)

    def general(st, crashed, append_n, link, loss_rate, round_base, extras):
        """k sim.steps threading the extras; (SimState, *extras')."""
        gids = sim_mod.group_ids_of(cfg, st.term.device)
        res = (st,) + tuple(extras)
        for r in range(k):
            kw = {}
            if with_counters:
                kw["counters"] = res[1]
            if with_health:
                kw["health"] = res[-1]
            if with_chaos:
                kw["link"] = link & ~link_loss_draw(round_base + r, loss_rate,
                                                    group_ids=gids)
            out = sim_mod.step(cfg, res[0], crashed, append_n, **kw)
            # SimState is itself a tuple: wrap by flag, not by isinstance.
            res = out if n_extra else (out,)
        return res

    def fn(st: SimState, crashed, append_n, *rest):
        if count_fused:
            rest, acc = rest[:-1], rest[-1]
        link = loss_rate = round_base = None
        if with_chaos:
            (link, loss_rate, round_base), rest = rest[:3], rest[3:]
            check_round_base(round_base, k)
        if len(rest) != n_extra:
            raise TypeError(f"expected {n_extra} extras, got {len(rest)}")
        with profiling.annotate("dispatch.predicate"):
            pred = steady_predicate(cfg, st, crashed, horizon=k, link=link,
                                    loss_rate=loss_rate)
        with profiling.annotate("dispatch.wait"):
            pred = sharding.all_ranks(cfg, pred)
        if pred:
            lead = (loss_rate, round_base) if with_chaos else ()
            res = fused_fn(st, crashed, append_n, *lead, *rest)
            res = res if n_extra else (res,)
        else:
            res = general(st, crashed, append_n, link, loss_rate, round_base, rest)
        if count_fused:
            return res + (acc + (k * cfg.n_groups if pred else 0),)
        return res if n_extra else res[0]

    return fn


def hybrid_multi_round(
    cfg: SimConfig, k: int = 16, storm_slots: int = 4096,
    with_chaos: bool = False, count_fused: bool = False,
    device: DeviceLike = None,
):
    """k protocol rounds with a PER-GROUP steady/general split, the
    reference's hybrid_multi_round.  fast_multi_round sends the whole batch
    down k general steps when any group is not steady; this dispatcher
    gathers the (few) non-steady "storm" groups into a [., storm_slots]
    sub-batch (a stable argsort of steady_mask, storm groups first),
    advances it with k general sim.steps keyed by the groups' global ids,
    runs the fused kernel over the whole batch, and scatters the sub-batch
    results over the storm groups' discarded fused outputs.  Groups are
    independent, so the split equals k sequential sim.steps bit for bit.

    fn(st, crashed, append_n) -> SimState; with `with_chaos`, fn(st,
    crashed, append_n, link, loss_rate, round_base) as fast_multi_round's,
    the storm sub-batch drawing its loss with link_loss_draw(group_ids=)
    and the fused branch running chaos_round (damped_round for a damped
    config).  With `count_fused`, one more argument last, the fused
    group-round count so far (a Python int), is returned last, increased by
    k * (the number of groups that ran fused).

    Three branches, chosen on the host from one count of the storm groups
    (one device sync a block), where the reference's lax.cond picks:
    "pure", the fused kernel alone, when no group storms; "split" when at
    most storm_slots groups storm; "slow", k general steps on the whole
    batch, otherwise.  `fn.last_branch` names the branch of the last call.
    As in the reference, the health planes are not threaded.  The fn runs
    on `cuda` unless `device` says otherwise; the state must lie there."""
    dev = resolve_device(device)
    G = cfg.n_groups
    # The storm slots are of the whole batch; a mesh rank's sub-batch holds
    # at most its own block, which the "split" branch's global storm count
    # (<= slots) bounds as well.
    S_global = min(storm_slots, sim_mod.global_groups(cfg))
    S = min(S_global, G)
    base = sim_mod.group_base(cfg)
    fused_fn = (chaos_round if with_chaos else steady_round)(cfg, k)
    sub_cfg = cfg._replace(n_groups=S)

    def steps(c, st, crashed, append_n, link, loss_rate, round_base, group_ids=None):
        for r in range(k):
            kw = {}
            if with_chaos:
                kw["link"] = link & ~link_loss_draw(
                    round_base + r, loss_rate, group_ids=group_ids
                )
            st = sim_mod.step(c, st, crashed, append_n, group_ids=group_ids, **kw)
        return st

    def fn(st: SimState, crashed, append_n, *rest):
        if count_fused:
            rest, acc = rest[:-1], rest[-1]
        link = loss_rate = round_base = None
        if with_chaos:
            (link, loss_rate, round_base), rest = rest[:3], rest[3:]
            check_round_base(round_base, k)
        if rest:
            raise TypeError(f"unexpected arguments after append_n: {len(rest)}")
        if st.term.device.type != dev.type:
            raise ValueError(f"hybrid_multi_round on {dev}: the state lies on "
                             f"{st.term.device}")
        with profiling.annotate("dispatch.predicate"):
            mask = steady_mask(cfg, st, crashed, horizon=k, link=link,
                               loss_rate=loss_rate)
            n_local = (~mask).sum(dtype=I32)
        with profiling.annotate("dispatch.wait"):
            n_storm = sharding.sum_ranks(cfg, n_local)
        lead = (loss_rate, round_base) if with_chaos else ()
        if n_storm == 0:
            fn.last_branch = "pure"
            out = fused_fn(st, crashed, append_n, *lead)
        elif n_storm <= S_global:
            fn.last_branch = "split"
            # A stable sort keeps the original order: storm groups (False)
            # first, then steady padding, which keeps its fused result.
            idx = torch.argsort(mask.to(torch.int8), stable=True)[:S]
            take_sub = ~mask[idx]
            sub = SimState(*(None if v is None else v[..., idx] for v in st))
            sub_link = sub_loss = None
            if with_chaos:
                sub_link, sub_loss = link[..., idx], loss_rate[..., idx]
            sub = steps(sub_cfg, sub, crashed[:, idx], append_n[idx], sub_link,
                        sub_loss, round_base, group_ids=idx + base)
            fast = fused_fn(st, crashed, append_n, *lead)

            def merge(whole, part):
                if whole is None:
                    return None
                merged = whole.clone()
                merged[..., idx] = torch.where(take_sub, part, whole[..., idx])
                return merged

            out = SimState(*map(merge, fast, sub))
        else:
            fn.last_branch = "slow"
            out = steps(cfg, st, crashed, append_n, link, loss_rate, round_base,
                        group_ids=sim_mod.group_ids_of(cfg, st.term.device))
        if count_fused:
            ran = G - int(n_local) if n_storm <= S_global else 0
            return out, acc + k * ran
        return out

    fn.last_branch = None
    return fn
