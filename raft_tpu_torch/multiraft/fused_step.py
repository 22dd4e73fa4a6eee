"""The steady-state dispatcher: run k protocol rounds on the fused kernel
when the steady invariant provably holds for all of them, else k general
steps.  Both branches give the same state, bit for bit.

Counterpart of the undamped, unlinked, uninstrumented arm of
`raft_tpu/multiraft/pallas_step.py`: `steady_mask` (:1355-1554),
`steady_predicate` (:1557), `steady_round` with its host wrapper `_run`
(:549-718) and `fast_multi_round` (:1605-1782, the arm at :1759-1782 with
`count_fused`).

The reference's `lax.cond` on the predicate becomes a host `bool(pred)`:
one device sync per k-round block.  The gather of the acting leader's
matched row before the kernel and the matched scatter and `agree` update
after it stay plain PyTorch, as the reference leaves them to XLA; at
100k groups × 5 peers they move more bytes than the kernel itself.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import sim as sim_mod
from .kernels import ROLE_LEADER
from .sim import SimConfig, SimState
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
    already at the leader's term, not in joint config."""
    sim_mod.check_supported(
        cfg, link=link, reconfig_pending=reconfig_pending,
        loss_rate=loss_rate, read_pending=read_pending,
    )
    alive = ~crashed
    # 1. nobody can campaign within the horizon.  With heartbeat_tick == 1
    # an alive follower under a live leader is re-synced every round, so
    # only its first tick uses the current ee; crashed peers' timers run
    # free.  Larger heartbeat ticks use the free-running bound for all.
    non_leader_voter = (st.state != ROLE_LEADER) & st.voter_mask
    if cfg.heartbeat_tick == 1:
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
    return no_campaign & one_leader & terms_ok & not_joint


def steady_predicate(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,
    horizon: int = 1,
    link=None,
    loss_rate=None,
) -> torch.Tensor:
    """0-dim bool tensor: True iff every group satisfies the steady
    invariant (see steady_mask)."""
    return steady_mask(cfg, st, crashed, horizon, link, loss_rate=loss_rate).all()


def steady_round(
    cfg: SimConfig, rounds: int = 1
) -> Callable[[SimState, torch.Tensor, torch.Tensor], SimState]:
    """fn(st, crashed, append_n) -> SimState advancing `rounds` fused steady
    rounds (same crashed/append each round).  Valid only where
    steady_predicate(cfg, st, crashed, horizon=rounds) holds."""
    sim_mod.check_supported(cfg)

    def fn(st: SimState, crashed: torch.Tensor, append_n: torch.Tensor) -> SimState:
        # The acting leader is fixed for the whole steady horizon, so its
        # tracker row and term start are gathered once before the kernel
        # and scattered back after it.
        is_leader = (st.state == ROLE_LEADER) & ~crashed
        f = is_leader.to(I32)
        acting_row = (st.matched * f[:, None, :]).sum(0, dtype=I32)  # [P, G]
        ts_acting = (st.term_start_index * f).sum(0, dtype=I32)  # [G]
        member = st.voter_mask | st.learner_mask
        ee, hb, li, lt, new_row, commit = steady_rounds(
            st.state, st.term, st.election_elapsed, st.heartbeat_elapsed,
            st.last_index, st.last_term, acting_row, st.commit,
            st.voter_mask, member, crashed, ts_acting, append_n,
            rounds=rounds, election_tick=cfg.election_tick,
            heartbeat_tick=cfg.heartbeat_tick,
        )
        matched = torch.where(is_leader[:, None, :], new_row[None, :, :], st.matched)
        # Pairwise log agreement, applied once for the whole horizon (the
        # sync set is constant while steady; only the final last index
        # of the leader matters).
        in_s = (member & ~crashed) | is_leader
        lead_last = torch.where(is_leader, li, 0).amax(0)  # [G]
        lead_row = (st.agree * f[:, None, :]).sum(0, dtype=I32)  # [P, G]
        agree = torch.where(
            in_s[:, None, :] & in_s[None, :, :],
            lead_last[None, None, :],
            torch.where(
                in_s[:, None, :],
                lead_row[None, :, :],
                torch.where(in_s[None, :, :], lead_row[:, None, :], st.agree),
            ),
        )
        return st._replace(
            election_elapsed=ee,
            heartbeat_elapsed=hb,
            last_index=li,
            last_term=lt,
            matched=matched,
            commit=commit,
            agree=agree,
        )

    return fn


def fast_multi_round(cfg: SimConfig, k: int = 16, count_fused: bool = False):
    """Dispatcher advancing k protocol rounds per call (same crashed/append
    every round): the fused kernel when provably steady for the whole
    horizon, else k sequential general steps.  Semantically identical to
    calling sim.step k times.

    fn(st, crashed, append_n) -> SimState.  With `count_fused`, fn takes
    one more argument, the fused group-round count so far (a Python int),
    and returns (SimState, count + k * n_groups if the fused branch ran,
    else count)."""
    fused_fn = steady_round(cfg, rounds=k)

    def fn(st: SimState, crashed, append_n, *acc):
        pred = bool(steady_predicate(cfg, st, crashed, horizon=k))
        if pred:
            out = fused_fn(st, crashed, append_n)
        else:
            out = st
            for _ in range(k):
                out = sim_mod.step(cfg, out, crashed, append_n)
        if not count_fused:
            return out
        return out, acc[0] + (k * cfg.n_groups if pred else 0)

    return fn
