"""The unified runner factory: one :func:`make_runner` entry point builds
every whole-scenario runner (chaos only, reconfig with an optional chaos
overlay, the client workload, the two split-horizon variants and the
autopilot cadence segment) from the schedule registry (``schedules.py``)
over the shared round body (``reconfig._runner_body``).

Counterpart of `raft_tpu/multiraft/runner.py` (all of it).  The legacy
entry points (``chaos.make_runner``, ``reconfig.make_runner`` and
``make_split_runner``, ``workload.make_runner`` and ``make_split_runner``,
``autopilot.make_cadence_runner``) are thin wrappers over this module,
with their signatures and outputs unchanged.

Where the reference traces one jitted ``lax.scan`` a runner and picks a
split block's arm with ``lax.cond``, a runner here is a host loop over the
rounds whose body queues device work only, and a split block's arm is one
host ``bool()`` of the same predicate.  On a rank of a mesh run (the
config's ``shard`` set) the runner advances the rank's block of groups and
that predicate is reduced over every rank (``sharding.all_ranks``), so
every rank takes the reference's arm; the accumulators it returns are the
rank's partial sums, which ``ClusterSim(mesh=)`` reduces.  There is no
jit boundary, so the schedules are closed over; :func:`flatten`,
:func:`rebuild` and :func:`schedule_args` still give the registry's flat
order, and each runner exposes it as ``runner.schedule_args``.  The reference's
``interpret=`` (Pallas interpret mode) has no counterpart: a fused block
runs the CUDA kernel on a CUDA tensor and its plain version on a CPU one.

Dispatch::

    make_runner(cfg, [chaos_c])                      -> chaos runner
    make_runner(cfg, [reconfig_c, chaos_c])          -> reconfig runner
    make_runner(cfg, [reconfig_c, chaos_c],
                split=True, k=8, window=4)           -> reconfig split
    make_runner(cfg, [client_c, chaos_c, reconfig_c]) -> workload runner
    make_runner(cfg, [client_c], split=True, k=8)    -> workload split
    make_runner(cfg, [reconfig_c, chaos_c],
                cadence=rounds, fused=...)           -> cadence segment

Compiled schedules are classified by type (chaos.CompiledChaos,
reconfig.CompiledReconfig, workload.CompiledClient); ``None`` entries are
skipped so call sites can pass optional schedules straight through.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import chaos as chaos_mod
from . import fused_step
from . import kernels
from . import sharding
from . import reconfig as reconfig_mod
from . import schedules as schedules_mod
from . import sim as sim_mod
from . import workload as workload_mod
from .autopilot import empty_reconfig_schedule
from .kernels import HP_LEADERLESS, N_SAFETY

I32 = torch.int32

__all__ = [
    "make_runner",
    "flatten",
    "rebuild",
    "rebuild_scheds",
    "schedule_args",
    "family_of",
]


# --- registry-driven schedule plumbing --------------------------------------

# Compiled-tuple type -> registry family; the one classification table the
# dispatcher and the flat-arg helpers share.
_FAMILY_TYPES: Tuple[Tuple[str, type], ...] = (
    ("chaos", chaos_mod.CompiledChaos),
    ("reconfig", reconfig_mod.CompiledReconfig),
    ("client", workload_mod.CompiledClient),
)


def family_of(compiled) -> str:
    """Registry family name of one compiled schedule tuple."""
    for name, typ in _FAMILY_TYPES:
        if isinstance(compiled, typ):
            return name
    raise TypeError(
        f"not a compiled schedule: {type(compiled).__name__} (expected "
        "chaos.CompiledChaos, reconfig.CompiledReconfig, or "
        "workload.CompiledClient)"
    )


def flatten(family: str, compiled) -> Tuple:
    """One compiled schedule as its flat array tuple, in registry order
    (schedules.array_fields)."""
    return tuple(
        getattr(compiled, f) for f in schedules_mod.array_fields(family)
    )


def rebuild(family: str, template, args):
    """Rebind a flat array tuple onto its compiled template: the inverse
    of :func:`flatten` (extra trailing arrays are ignored)."""
    fields = schedules_mod.array_fields(family)
    return template._replace(**dict(zip(fields, args[: len(fields)])))


def schedule_args(*scheds) -> Tuple:
    """The flat array tuple of several compiled schedules, each in its
    family's registry order, ``None`` entries skipped: the reference's
    trailing runtime arguments of every runner jit."""
    out: Tuple = ()
    for s in scheds:
        if s is not None:
            out = out + flatten(family_of(s), s)
    return out


def rebuild_scheds(compiled, chaos_compiled, sched_args):
    """Rebind flat schedule arrays onto the compiled reconfig (and
    optional chaos) templates: the inverse of
    ``schedule_args(compiled, chaos_compiled)``."""
    n = len(schedules_mod.array_fields("reconfig"))
    sched = rebuild("reconfig", compiled, sched_args[:n])
    if chaos_compiled is not None:
        chaos_sched = rebuild("chaos", chaos_compiled, sched_args[n:])
    else:
        chaos_sched = None
    return sched, chaos_sched


# --- the runner constructors ------------------------------------------------


def _make_chaos(cfg: sim_mod.SimConfig, compiled: chaos_mod.CompiledChaos):
    """The chaos-only whole-scenario runner (chaos.make_runner's contract):
    its own lean round, with no op protocol and no read carry."""
    G = compiled.append.shape[1]
    if (compiled.n_peers, G) != (cfg.n_peers, cfg.n_groups):
        raise ValueError(
            f"the schedule is compiled for {compiled.n_peers} peers x {G} "
            f"groups, the config has {cfg.n_peers} x {cfg.n_groups}"
        )
    dev = compiled.append.device
    gids = sim_mod.group_ids_of(cfg, dev)

    def runner(st: sim_mod.SimState, health: sim_mod.HealthState, *bb):
        if st.term.device != dev or health.planes.device != dev:
            raise ValueError(
                f"the state and health planes must lie on the schedule's "
                f"device {dev}, got {st.term.device} and {health.planes.device}"
            )
        sim_mod.check_blackbox_arg(cfg, bb)
        stats = torch.zeros((chaos_mod.N_CHAOS_STATS,), dtype=I32, device=dev)
        safety = torch.zeros((N_SAFETY,), dtype=I32, device=dev)
        for r in range(compiled.n_rounds):
            link, crashed, append = chaos_mod.schedule_masks(compiled, r, gids)
            prev_leaderless = health.planes[HP_LEADERLESS]
            st2, health = sim_mod.step(cfg, st, crashed, append, health=health,
                                       link=link)
            audit = (st2.state, st2.term, st2.commit, st2.last_index, st2.agree,
                     st.commit)
            if bb:
                viol = kernels.check_safety_groups(*audit)
                safety = safety + viol.sum(1, dtype=I32)
                bb = (sim_mod.BlackboxState(*kernels.blackbox_fold(
                    *bb[0], st2.state, st2.term, st2.commit, crashed, viol
                )),)
            else:
                safety = safety + kernels.check_safety(*audit)
            stats = chaos_mod.update_chaos_stats(
                stats, prev_leaderless, health.planes[HP_LEADERLESS]
            )
            st = st2
        return (st, health) + bb + (stats, safety)

    runner.schedule_args = schedule_args(compiled)  # type: ignore[attr-defined]
    return runner


def _make_reconfig(
    cfg: sim_mod.SimConfig,
    compiled: reconfig_mod.CompiledReconfig,
    chaos_compiled: Optional[chaos_mod.CompiledChaos],
):
    """The reconfig(+chaos) whole-scenario runner (reconfig.make_runner's
    contract): every round through _runner_body, then the tail audit."""
    reconfig_mod._validate_plans(cfg, compiled, chaos_compiled)
    body = reconfig_mod._runner_body(cfg, compiled, chaos_compiled)
    dev = compiled.append.device

    def runner(st: sim_mod.SimState, hl: sim_mod.HealthState,
               rst: reconfig_mod.ReconfigState, *bb):
        reconfig_mod._check_device(st, hl, dev)
        sim_mod.check_blackbox_arg(cfg, bb)
        carry = (st, hl, rst) + reconfig_mod._zero_accumulators(dev) + bb
        for r in range(compiled.n_rounds):
            carry = body(carry, r)
        stf, hlf, rstf, stats, rstats, safety = carry[:6]
        safety, bbf = reconfig_mod._tail_audit(safety, stf, rstf, *carry[6:])
        out = (stf, hlf, rstf, stats, rstats, safety)
        return out + (bbf,) if bb else out

    runner.schedule_args = schedule_args(compiled, chaos_compiled)  # type: ignore[attr-defined]
    return runner


def _make_reconfig_split(
    cfg: sim_mod.SimConfig,
    compiled: reconfig_mod.CompiledReconfig,
    chaos_compiled: Optional[chaos_mod.CompiledChaos],
    k: int,
    window: int,
    with_counters: bool,
    segments=None,
):
    """The split-horizon reconfig runner (reconfig.make_split_runner's
    contract): planned general segments run _runner_body round by round;
    each planned fused block runs the fused kernel when the whole batch is
    steady for its horizon (one host bool()), else k general rounds.
    `segments` overrides the split plan (a mesh rank passes the plan of
    the whole batch's schedule)."""
    P, G = cfg.n_peers, cfg.n_groups
    if not cfg.collect_health:
        raise ValueError(
            "make_split_runner needs SimConfig(collect_health=True) — the "
            "MTTR stats and the fused block's closed-form fold ride on the "
            "health planes"
        )
    if cfg.blackbox:
        raise ValueError(
            "make_split_runner does not thread the black box — use the "
            "unsplit runner"
        )
    if k > cfg.health_window:
        raise ValueError(
            f"fused block k={k} exceeds health_window={cfg.health_window}: "
            "the closed-form health fold handles at most one churn-window "
            "crossing per block"
        )
    reconfig_mod._validate_plans(cfg, compiled, chaos_compiled)
    chaos_on = chaos_compiled is not None
    if segments is None:
        segments = reconfig_mod.split_plan(compiled, k, chaos_compiled, window)
    if not (segments and segments[0].start == 0
            and sum(s.rounds for s in segments) == compiled.n_rounds):
        raise AssertionError("split_plan must tile the horizon exactly")
    fused_fn = (fused_step.chaos_round if chaos_on else fused_step.steady_round)(
        cfg, k, with_health=True, with_counters=with_counters
    )
    body = reconfig_mod._runner_body(cfg, compiled, chaos_compiled, with_counters)
    dev = compiled.append.device
    no_crash = torch.zeros((P, G), dtype=torch.bool, device=dev)

    def fused_block(carry, r0: int):
        """k rounds from r0: the fused kernel if the whole batch is steady
        for the horizon, else k general rounds; (carry', fused?)."""
        st, hl, rst, stats, rstats, safety, *c = carry
        if chaos_on:
            link, loss, crashed, capp = chaos_mod.schedule_planes(
                chaos_compiled, r0
            )
        else:
            link = loss = None
            crashed, capp = no_crash, 0
        append = compiled.append[int(compiled.phase_of_round[r0])] + capp
        pend = reconfig_mod.pending_in_horizon(compiled, rst, r0, k)
        mask = fused_step.steady_mask(
            cfg, st, crashed, horizon=k, link=link, reconfig_pending=pend,
            loss_rate=loss,
        )
        if not sharding.all_ranks(cfg, mask.all()):
            for r in range(r0, r0 + k):
                carry = body(carry, r)
            return carry, False
        prev_ll = hl.planes[HP_LEADERLESS]
        fargs = (st, crashed, append) + ((loss, r0) if chaos_on else ())
        out = fused_fn(*fargs, *c, hl)
        st2, hl2 = out[0], out[-1]
        # One closed-form MTTR fold for the whole block: the fused health
        # fold holds HP_LEADERLESS at 0 every round (a leader held), so k
        # per-round folds telescope to this one.
        stats2 = chaos_mod.update_chaos_stats(
            stats, prev_ll, hl2.planes[HP_LEADERLESS]
        )
        # No op proposed, gated or applied and no mask moved: only the
        # transition-audit anchors refresh, as k general no-op rounds
        # would leave them.
        rst2 = rst._replace(
            prev_voter=st2.voter_mask, prev_outgoing=st2.outgoing_mask
        )
        res = (st2, hl2, rst2, stats2, rstats, safety)
        return (res + (out[1],) if with_counters else res), True

    def runner(st: sim_mod.SimState, hl: sim_mod.HealthState,
               rst: reconfig_mod.ReconfigState,
               counters: Optional[torch.Tensor] = None):
        if with_counters and counters is None:
            raise ValueError(
                "runner built with_counters=True needs the counters plane"
            )
        reconfig_mod._check_device(st, hl, dev)
        carry = (st, hl, rst) + reconfig_mod._zero_accumulators(dev)
        if with_counters:
            carry = carry + (counters,)
        fused = 0
        runner.blocks = []
        for seg in segments:
            if seg.fused:
                for r0 in range(seg.start, seg.start + seg.rounds, k):
                    carry, ran = fused_block(carry, r0)
                    fused += k * G if ran else 0
                    runner.blocks.append((r0, ran))
            else:
                for r in range(seg.start, seg.start + seg.rounds):
                    carry = body(carry, r)
        stf, hlf, rstf, stats, rstats, safety = carry[:6]
        out = (stf, hlf, rstf, stats, rstats,
               reconfig_mod._tail_audit(safety, stf, rstf)[0], fused)
        return out + (carry[6],) if with_counters else out

    runner.segments = segments  # type: ignore[attr-defined]
    runner.blocks = []  # type: ignore[attr-defined]
    runner.fused_block = fused_block  # type: ignore[attr-defined]
    runner.general_round = body  # type: ignore[attr-defined]
    runner.schedule_args = schedule_args(compiled, chaos_compiled)  # type: ignore[attr-defined]
    return runner


def _make_workload(
    cfg: sim_mod.SimConfig,
    client: workload_mod.CompiledClient,
    chaos_compiled: Optional[chaos_mod.CompiledChaos],
    reconfig_compiled: Optional[reconfig_mod.CompiledReconfig],
):
    """The client-workload whole-scenario runner (workload.make_runner's
    contract): _runner_body with the read protocol threaded; a missing
    reconfig plan runs the no-op schedule."""
    workload_mod._validate(cfg, client, chaos_compiled, reconfig_compiled)
    dev = client.append.device
    if reconfig_compiled is None:
        reconfig_compiled = empty_reconfig_schedule(
            client.n_rounds, cfg.n_peers, cfg.n_groups, dev
        )
    body = reconfig_mod._runner_body(
        cfg, reconfig_compiled, chaos_compiled, client=client
    )

    def runner(st: sim_mod.SimState, hl: sim_mod.HealthState,
               rst: reconfig_mod.ReconfigState, rcar: workload_mod.ReadCarry,
               *bb):
        workload_mod._check_device(st, hl, rcar, dev)
        sim_mod.check_blackbox_arg(cfg, bb)
        carry = ((st, hl, rst) + reconfig_mod._zero_accumulators(dev) + (rcar,)
                 + workload_mod._zero_read_accumulators(dev) + bb)
        for r in range(client.n_rounds):
            carry = body(carry, r)
        stf, hlf, rstf, stats, rstats, safety, rcarf, rdstats, lat_hist = carry[:9]
        safety, bbf = reconfig_mod._tail_audit(safety, stf, rstf, *carry[9:])
        out = (stf, hlf, rstf, stats, rstats, safety, rcarf, rdstats, lat_hist)
        return out + (bbf,) if bb else out

    runner.schedule_args = schedule_args(  # type: ignore[attr-defined]
        client, reconfig_compiled, chaos_compiled
    )
    return runner


def _make_workload_split(
    cfg: sim_mod.SimConfig,
    client: workload_mod.CompiledClient,
    k: int,
    chaos_compiled,
    reconfig_compiled,
):
    """The fused client-workload runner (workload.make_split_runner's
    contract): k-round blocks behind the steady and provably servable
    lease predicate (one host bool() a block), lease receipts folded in
    closed form on the fused arm."""
    if chaos_compiled is not None or reconfig_compiled is not None:
        raise ValueError(
            "make_split_runner runs bare client plans; compose chaos/"
            "reconfig schedules through the unsplit runner (or the "
            "reconfig split machinery) instead"
        )
    if cfg.blackbox:
        raise ValueError(
            "make_split_runner does not thread the black box — use the "
            "unsplit runner"
        )
    if not cfg.collect_health:
        raise ValueError(
            "make_split_runner needs SimConfig(collect_health=True) — "
            "the MTTR stats and the fused block's closed-form fold ride "
            "on the health planes"
        )
    if k > cfg.health_window:
        raise ValueError(
            f"fused block k={k} exceeds health_window="
            f"{cfg.health_window}: the closed-form health fold handles "
            "at most one churn-window crossing per block"
        )
    workload_mod._validate(cfg, client, None, None)
    P, G = cfg.n_peers, cfg.n_groups
    R = client.n_rounds
    dev = client.append.device
    sched = empty_reconfig_schedule(R, P, G, dev)
    body = reconfig_mod._runner_body(cfg, sched, None, client=client)
    fused_fn = fused_step.steady_round(cfg, rounds=k, with_health=True)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    phases = client.phase_of_round.tolist()

    def steady_block(carry, r0: int):
        """The block's lease fires per group (int32[G]) when the block from
        r0 may run fused, else None; one host sync."""
        st, rcar = carry[0], carry[6]
        if phases[r0] != phases[r0 + k - 1]:
            return None
        read_block = workload_mod.reads_pending_in_horizon(client, rcar, r0, k, cfg)
        n_lease, any_lease = workload_mod.lease_fires_in_block(client, r0, k, cfg)
        lease_prov = ~any_lease
        if cfg.heartbeat_tick == 1:
            _, lease_entry, _ = kernels.lease_read(
                st.state, st.term, st.leader_id, st.election_elapsed,
                st.commit, st.term_start_index, crashed, cfg.election_tick,
                cfg.check_quorum and cfg.lease_read, st.transferee,
                st.recent_active, st.voter_mask, st.outgoing_mask,
            )
            lease_prov = lease_prov | lease_entry
        mask = fused_step.steady_mask(cfg, st, crashed, horizon=k,
                                      read_pending=read_block)
        return n_lease if sharding.all_ranks(cfg, (mask & lease_prov).all()) else None

    def fused_block(carry, r0: int, n_lease: torch.Tensor):
        st, hl, rst, stats, rstats, safety, rcar, rdstats, lat = carry
        prev_ll = hl.planes[HP_LEADERLESS]
        st2, hl2 = fused_fn(st, crashed, client.append[phases[r0]], hl)
        stats2 = chaos_mod.update_chaos_stats(
            stats, prev_ll, hl2.planes[HP_LEADERLESS]
        )
        # The op protocol never moves (the no-op schedule); only the
        # transition-audit anchors refresh.
        rst2 = rst._replace(
            prev_voter=st2.voter_mask, prev_outgoing=st2.outgoing_mask
        )
        # Closed-form receipts: every lease fire in the block issues fresh
        # (the carry is empty: read_block rejected otherwise) and serves the
        # round it fires, at latency 0.
        n_served = n_lease.sum(dtype=I32)
        zero = torch.zeros_like(n_served)
        lat2 = torch.cat([(lat[0] + n_served)[None], lat[1:]])
        bump = [zero] * workload_mod.N_READ_STATS
        bump[workload_mod.RS_ISSUED] = bump[workload_mod.RS_SERVED_LEASE] = n_served
        return (st2, hl2, rst2, stats2, rstats, safety, rcar,
                rdstats + torch.stack(bump), lat2)

    def runner(st: sim_mod.SimState, hl: sim_mod.HealthState,
               rst: reconfig_mod.ReconfigState, rcar: workload_mod.ReadCarry):
        workload_mod._check_device(st, hl, rcar, dev)
        carry = ((st, hl, rst) + reconfig_mod._zero_accumulators(dev) + (rcar,)
                 + workload_mod._zero_read_accumulators(dev))
        fused = 0
        runner.blocks = []
        n_blocks = R // k
        for b in range(n_blocks):
            r0 = b * k
            n_lease = steady_block(carry, r0)
            ran = n_lease is not None
            if ran:
                carry = fused_block(carry, r0, n_lease)
                fused += k * G
            else:
                for r in range(r0, r0 + k):
                    carry = body(carry, r)
            runner.blocks.append((r0, ran))
        for r in range(n_blocks * k, R):
            carry = body(carry, r)
        stf, hlf, rstf, stats, rstats, safety, rcarf, rdstats, lat_hist = carry
        # The unsplit runner's tail audit, for bit-parity.
        safety = reconfig_mod._tail_audit(safety, stf, rstf)[0]
        return (stf, hlf, rstf, stats, rstats, safety, rcarf, rdstats,
                lat_hist, fused)

    runner.blocks = []  # type: ignore[attr-defined]
    runner.steady_block = steady_block  # type: ignore[attr-defined]
    runner.fused_block = fused_block  # type: ignore[attr-defined]
    runner.schedule_args = schedule_args(client, sched)  # type: ignore[attr-defined]
    return runner


def _make_cadence(
    cfg: sim_mod.SimConfig,
    compiled: reconfig_mod.CompiledReconfig,
    chaos_compiled: Optional[chaos_mod.CompiledChaos],
    rounds: int,
    fused: bool,
):
    """One autopilot cadence segment (autopilot.make_cadence_runner's
    contract): `rounds` rounds of _runner_body with the action planes
    applied at the segment's first round, plus the commit-stall fold;
    `fused=True` adds the fused arm, chosen by one host bool() of the
    reference's predicate."""
    if not cfg.collect_health:
        raise ValueError("the autopilot needs SimConfig(collect_health=True)")
    if not cfg.transfer:
        raise ValueError(
            "the autopilot needs SimConfig(transfer=True) — the transfer "
            "actuation rides the lead_transferee plane"
        )
    reconfig_mod._validate_plans(cfg, compiled, chaos_compiled)
    P, G = cfg.n_peers, cfg.n_groups
    chaos_on = chaos_compiled is not None
    dev = compiled.append.device
    no_crash = torch.zeros((P, G), dtype=torch.bool, device=dev)
    if fused:
        fused_fn = (fused_step.chaos_round if chaos_on else fused_step.steady_round)(
            cfg, rounds, with_health=True
        )

    def general(inner, csr, r0, transfer, kick):
        # _runner_body carries the BlackboxState last in `inner`.
        body = reconfig_mod._runner_body(
            cfg, compiled, chaos_compiled, actions=(r0, transfer, kick)
        )
        for r in range(r0, r0 + rounds):
            inner = body(inner, r)
            csr = csr + (
                inner[1].planes[kernels.HP_SINCE_COMMIT] >= cfg.commit_stall_ticks
            ).sum(dtype=I32)
        return inner + (csr, 0)

    def half_quorum(alive, mask):
        n = mask.sum(0, dtype=I32)
        got = (alive & mask).sum(0, dtype=I32)
        return (got >= kernels.majority_of(n)) | (n == 0)

    def runner(st, hl, rst, stats, rstats, safety, *rest):
        bb, (csr, r0, transfer, kick) = rest[:-4], rest[-4:]
        reconfig_mod._check_device(st, hl, dev)
        sim_mod.check_blackbox_arg(cfg, bb)
        if r0 + rounds > compiled.n_rounds:
            raise ValueError(
                f"a {rounds}-round segment from round {r0} overruns the "
                f"{compiled.n_rounds}-round schedule"
            )
        inner = (st, hl, rst, stats, rstats, safety) + bb
        if not fused:
            return general(inner, csr, r0, transfer, kick)
        # The fused kernel gathers the round-r0 masks once for the whole
        # block, so no schedule phase may change inside it (phases are
        # contiguous: the endpoints decide).
        last = r0 + rounds - 1
        same_phase = int(compiled.phase_of_round[r0]) == int(
            compiled.phase_of_round[last]
        )
        if chaos_on:
            same_phase = same_phase and int(chaos_compiled.phase_of_round[r0]) == int(
                chaos_compiled.phase_of_round[last]
            )
        if not same_phase:
            return general(inner, csr, r0, transfer, kick)
        if chaos_on:
            link, loss, crashed, capp = chaos_mod.schedule_planes(chaos_compiled, r0)
        else:
            link = loss = None
            crashed, capp = no_crash, 0
        append = compiled.append[int(compiled.phase_of_round[r0])] + capp
        pend = reconfig_mod.pending_in_horizon(compiled, rst, r0, rounds)
        mask = fused_step.steady_mask(
            cfg, st, crashed, horizon=rounds, link=link, reconfig_pending=pend,
            loss_rate=loss,
        )
        no_action = ~(transfer > 0).any() & ~kick.any()
        # steady_mask admits horizons where commits stall (one alive leader
        # over a crashed majority, or loss); the closed-form zero stall
        # fold needs provable progress: an alive voter quorum in both
        # halves and no loss.
        alive = ~crashed
        progress_ok = (
            half_quorum(alive, st.voter_mask) & half_quorum(alive, st.outgoing_mask)
        ).all()
        if loss is not None:
            progress_ok = progress_ok & (loss == 0).all()
        pred = mask.all() & no_action & progress_ok & (append > 0).all()
        if not sharding.all_ranks(cfg, pred):
            return general(inner, csr, r0, transfer, kick)
        prev_ll = hl.planes[kernels.HP_LEADERLESS]
        fargs = (st, crashed, append) + ((loss, r0) if chaos_on else ())
        out = fused_fn(*fargs, hl)
        st2, hl2 = out[0], out[-1]
        stats2 = chaos_mod.update_chaos_stats(
            stats, prev_ll, hl2.planes[kernels.HP_LEADERLESS]
        )
        # No op, no action, commits every round: only the transition-audit
        # anchors refresh, and the commit-stall fold is exactly zero.
        rst2 = rst._replace(
            prev_voter=st2.voter_mask, prev_outgoing=st2.outgoing_mask
        )
        return (st2, hl2, rst2, stats2, rstats, safety) + bb + (csr, rounds * G)

    runner.schedule_args = schedule_args(compiled, chaos_compiled)  # type: ignore[attr-defined]
    return runner


# --- the one entry point ----------------------------------------------------


def make_runner(
    cfg: sim_mod.SimConfig,
    schedules: Sequence = (),
    *,
    split: bool = False,
    cadence: Optional[int] = None,
    k: int = 8,
    window: int = 4,
    with_counters: bool = False,
    fused: bool = False,
    segments=None,
):
    """Build a whole-scenario runner from compiled schedules.

    `schedules` is any mix of chaos.CompiledChaos,
    reconfig.CompiledReconfig and workload.CompiledClient (at most one
    each; None entries skipped); the variant is picked by what is present
    and by the `split` / `cadence` selectors (the module docstring's
    table; each legacy wrapper's docstring gives its variant's full
    contract).  Every runner runs on the device its schedules lie on:
    `cuda` unless they were compiled for the CPU.  Each runner exposes
    ``.schedule_args``; the split runners also their block functions and
    ``.blocks`` (and the reconfig split runner ``.segments``, which
    `segments` overrides: a mesh rank passes reconfig.split_plan of the
    whole batch's schedule, since its own block's would differ)."""
    by_family: Dict[str, object] = {}
    for s in schedules:
        if s is None:
            continue
        fam = family_of(s)
        if fam in by_family:
            raise ValueError(f"duplicate {fam} schedule")
        by_family[fam] = s
    chaos_c = by_family.get("chaos")
    reconfig_c = by_family.get("reconfig")
    client_c = by_family.get("client")

    if cadence is not None:
        if reconfig_c is None:
            raise ValueError(
                "cadence runners need a reconfig schedule (the autopilot's "
                "no-op template at rest)"
            )
        if client_c is not None:
            raise ValueError("cadence runners do not thread a client plan")
        return _make_cadence(cfg, reconfig_c, chaos_c, cadence, fused)
    if split:
        if client_c is not None:
            return _make_workload_split(cfg, client_c, k, chaos_c, reconfig_c)
        if reconfig_c is None:
            raise ValueError(
                "split runners need a reconfig or client schedule"
            )
        return _make_reconfig_split(
            cfg, reconfig_c, chaos_c, k, window, with_counters, segments
        )
    if client_c is not None:
        return _make_workload(cfg, client_c, chaos_c, reconfig_c)
    if reconfig_c is not None:
        return _make_reconfig(cfg, reconfig_c, chaos_c)
    if chaos_c is not None:
        return _make_chaos(cfg, chaos_c)
    raise ValueError("make_runner needs at least one compiled schedule")
