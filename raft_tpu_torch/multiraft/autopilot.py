"""The fleet autopilot: a closed loop that acts on the health planes.

Counterpart of `raft_tpu/multiraft/autopilot.py`: `AutopilotConfig`
(:78-126), `empty_reconfig_schedule` (:128-149), `make_cadence_runner`
(:152-193, a wrapper over the unified runner, whose `_make_cadence`
builds the segment as the reference's runner.py:785-951 does) and
`Autopilot` (:196-702).

A host-side declarative policy (`AutopilotConfig`: thresholds, budgets a
cadence, cooldowns) reads the device-reduced health summary at each
cadence boundary and emits batched actions that the device carries out:

  kick       `sim.step(campaign_kick=)`: a MsgHup at a chosen voter of a
             leaderless group, which ends the episode at the next cadence
             instead of after the randomized election timeout;
  transfer   `sim.step(transfer_propose=)`: the MsgTransferLeader /
             MsgTimeoutNow protocol (sim._transfer_phase), which moves
             leadership off an ack-starved leader or rebalances leader
             placement against a skewed workload;
  evacuate   a ReconfigPlan (remove the degraded voter, add a spare peer)
             compiled by reconfig.compile_plan and run by the same
             propose/gate/apply protocol as the chaos that triggered it.

A plan runs as cadence-sized segments (`make_cadence_runner` over
reconfig._runner_body, so the op protocol, the MTTR and safety folds and
the chaos masks are the reconfig runner's); between segments the summary
crosses to the host, the policy decides, and the next segment's first
round carries the action planes.  Where the reference traces one jitted
`lax.scan` a segment and picks its fused arm with a `lax.cond`, a segment
here is a host loop over the rounds, and the fused arm is chosen by one
host `bool()` of the same predicate.  The loop is deterministic: the same
plan, state and policy give the same actions round for round.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from . import chaos as chaos_mod
from . import kernels
from . import reconfig as reconfig_mod
from . import sim as sim_mod
from .health import HealthMonitor
from .platform import DeviceLike, resolve_device
from .reconfig import NO_ROUND, CompiledReconfig, ReconfigPhase, ReconfigPlan

I32 = torch.int32


class AutopilotConfig(NamedTuple):
    """The declarative autopilot policy: thresholds, budgets, cooldowns.
    It maps one health summary (and the `explain()` columns of the worst
    groups) to at most `max_*` actions a cadence."""

    # Rounds between health reads and action batches.
    cadence: int = 8
    # Campaign kick: a leaderless group whose HP_LEADERLESS plane is at or
    # over the threshold gets a MsgHup at its best-cursor voter.
    kick: bool = True
    kick_leaderless_ticks: int = 2
    max_kicks: int = 8
    # Leader transfer: a group with an alive leader whose commit has been
    # flat for the threshold moves its leadership to the best-cursor
    # follower voter.
    transfer: bool = True
    transfer_stall_ticks: int = 6
    max_transfers: int = 8
    # Evacuation: when at least evac_min_groups of the inspected worst
    # groups implicate the same lagging voter, their configs are walked
    # off it (remove-voter + add a spare peer) through the reconfig
    # protocol.  Off by default: it needs spare peers.
    evacuate: bool = False
    evac_stall_ticks: int = 12
    evac_min_groups: int = 2
    # Leader-placement balancing against a skewed workload: each cadence
    # also spends up to max_balance_transfers moving the heaviest groups
    # off the most-loaded leader peer (run_plan's `append` plane weighs
    # the groups).
    balance: bool = False
    max_balance_transfers: int = 4
    # Rounds before the policy may act on the same group again.
    cooldown: int = 8

    def validate(self) -> "AutopilotConfig":
        if self.cadence < 1:
            raise ValueError("cadence must be >= 1")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        return self


def empty_reconfig_schedule(
    n_rounds: int, n_peers: int, n_groups: int, device: DeviceLike = None
) -> CompiledReconfig:
    """A no-op CompiledReconfig spanning `n_rounds`: zero ops and zero extra
    append, so composing it through reconfig._runner_body leaves the
    op-protocol carry unmoved.  `phase_of_round` stays on the CPU, as
    compile_plan keeps it; the other arrays lie on `cuda` unless `device`
    says otherwise."""
    dev = resolve_device(device)
    P, G = n_peers, n_groups

    def masks():
        return torch.zeros((1, P, G), dtype=torch.bool, device=dev)

    return CompiledReconfig(
        phase_of_round=torch.zeros((n_rounds,), dtype=I32),
        append=torch.zeros((1, G), dtype=I32, device=dev),
        op_start=torch.full((1, G), NO_ROUND, dtype=I32, device=dev),
        n_ops=torch.zeros((G,), dtype=I32, device=dev),
        tgt_voter=masks(),
        tgt_outgoing=masks(),
        tgt_learner=masks(),
        added=masks(),
        removed=masks(),
        n_peers=P,
    )


def make_cadence_runner(
    cfg: sim_mod.SimConfig,
    compiled: Optional[CompiledReconfig],
    chaos_compiled: Optional[chaos_mod.CompiledChaos],
    rounds: int,
    fused: bool = False,
    client=None,
):
    """One autopilot cadence segment: `rounds` rounds of
    reconfig._runner_body (the chaos masks, the op protocol, the MTTR and
    safety folds) with the action planes applied at the segment's first
    round, plus a per-round commit-stall fold (the group-rounds whose
    HP_SINCE_COMMIT is at or over SimConfig.commit_stall_ticks).

    runner(st, hl, rst, stats, rstats, safety, csr, r0, transfer, kick) ->
    (st', hl', rst', stats', rstats', safety', csr', fused_rounds): csr is
    the int32 0-dim commit-stall accumulator, r0 (a Python int) the
    segment's first round, transfer int32[G] and kick bool[P, G] the
    action planes, and fused_rounds a Python int, rounds x n_groups when
    the fused arm ran and 0 otherwise.  With SimConfig(blackbox=True) the
    BlackboxState follows safety in the arguments and in the results
    (reconfig._runner_body's black-box arm); such a config never fuses
    (steady_mask rejects it).

    `fused=True` adds the fused arm, chosen by one host bool() of the
    reference's predicate over the whole batch: fused_step.steady_mask
    over the horizon (which rejects pending transfers and scheduled conf
    changes), no action in this segment, no schedule phase change inside
    it, an alive voter quorum in both config halves with no loss (so
    commits flow every round), and a positive append everywhere (so the
    commit-stall fold is exactly zero).  The arm then runs the fused
    kernel with the health planes (fused_step.chaos_round with a chaos
    schedule, else steady_round; the damped kernel for a damped config)
    and folds the MTTR stats once, equal to the general rounds bit for
    bit.  The runner adds no host sync of its own beyond that bool()."""
    from . import runner as runner_mod

    if client is not None:
        raise ValueError("cadence runners do not thread a client plan")
    return runner_mod.make_runner(
        cfg, (compiled, chaos_compiled), cadence=rounds, fused=fused
    )


class Autopilot:
    """The closed loop: drive a ClusterSim through a chaos plan in cadence
    segments, reading health and issuing batched heal actions between
    them.  The sim must be built with SimConfig(collect_health=True,
    transfer=True); on a black-box sim every round folds into its black
    box.  Everything runs on the sim's device.

    `monitor` (a health.HealthMonitor; default the sim's health_monitor)
    receives the per-cadence summaries and the final report; `metrics`
    (a scalar.metrics.Metrics) gets `autopilot.action` trace events, the
    actions counters and the pending-transfer gauge.  The sim is an
    unsharded one: a rank's block of a mesh run (ClusterSim(mesh=)) raises
    NotImplementedError, as the policy reads whole-batch planes."""

    def __init__(
        self,
        sim,
        cfg: AutopilotConfig = AutopilotConfig(),
        monitor=None,
        metrics=None,
        fused: bool = False,
    ):
        if getattr(sim, "mesh", None) is not None:
            raise NotImplementedError(
                "the autopilot drives an unsharded ClusterSim; a mesh rank's "
                "sim holds only its block of groups"
            )
        self.sim = sim
        self.cfg = cfg.validate()
        self.monitor = (
            monitor if monitor is not None else getattr(sim, "health_monitor", None)
        )
        self.metrics = metrics
        self.fused = fused
        self._cooldown_until: Dict[int, int] = {}
        # One retry counter a group, shared by kicks and transfers: the
        # policy cannot see liveness, so repeated attempts on a group rotate
        # through the target ranking instead of re-picking a dead
        # best-cursor peer forever.
        self._retry_rotation: Dict[int, int] = {}
        self._evacuated: Set[int] = set()
        self._runners: Dict[Tuple, object] = {}
        self.actions_taken = {"kicks": 0, "transfers": 0, "evacuations": 0}

    # --- policy -----------------------------------------------------------

    def _emit(self, kind: str, n: int, round_idx: int, detail) -> None:
        self.actions_taken[kind] += n
        m = self.metrics
        if m is not None and n:
            m.autopilot_actions.labels(kind=kind).inc(n)
            m.trace("autopilot.action", kind=kind, n=n, round=round_idx,
                    detail=detail)

    @staticmethod
    def _acting_leader_of(info: dict) -> int:
        """The acting leader from the per-peer role and term columns (role
        leader at the highest term, the lowest index on a tie), not from the
        leader_id views, which go stale on partitioned peers."""
        peers = info["peers"]
        best = 0
        best_term = -1
        for p, (role, term) in enumerate(zip(peers["state"], peers["term"])):
            if role == kernels.ROLE_LEADER and term > best_term:
                best, best_term = p + 1, term
        return best

    def _ranked_target(self, info: dict, exclude: int = 0, attempt: int = 0) -> int:
        """The healthiest-looking voter: ranked by (last_index, commit,
        -peer id) over the group's voters (learners and removed peers are
        never targets), skipping `exclude`; `attempt` rotates through the
        ranking across retries."""
        peers = info["peers"]
        voter = peers.get("voter", [True] * len(peers["last_index"]))
        ranked = sorted(
            (-li, -c, p + 1)
            for p, (li, c) in enumerate(zip(peers["last_index"], peers["commit"]))
            if p + 1 != exclude and voter[p]
        )
        if not ranked:
            return 0
        return ranked[attempt % len(ranked)][2]

    def _decide(
        self, summary: dict, round_idx: int
    ) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
        """One health summary to this cadence's action planes: (transfer
        int32[G], kick bool[P, G], inspected), `inspected` holding each
        worst group's explain() columns for the evacuation policy."""
        c = self.cfg
        G = self.sim.cfg.n_groups
        P = self.sim.cfg.n_peers
        transfer = np.zeros((G,), np.int32)
        kick = np.zeros((P, G), bool)
        kicks = transfers = 0
        inspected: List[dict] = []
        for w in summary.get("worst", ()):
            g, score = w["group"], w["score"]
            if score <= 0:
                continue
            info = self.sim.explain(g)
            inspected.append(info)
            if self._cooldown_until.get(g, -1) > round_idx:
                continue
            hp = info["health"]
            lead = self._acting_leader_of(info)
            if (
                c.kick
                and kicks < c.max_kicks
                and hp["leaderless_ticks"] >= c.kick_leaderless_ticks
            ):
                attempt = self._retry_rotation.get(g, 0)
                target = self._ranked_target(info, attempt=attempt)
                if target:
                    self._retry_rotation[g] = attempt + 1
                    kick[target - 1, g] = True
                    kicks += 1
                    self._cooldown_until[g] = round_idx + c.cooldown
            elif (
                c.transfer
                and transfers < c.max_transfers
                and lead > 0
                and hp["leaderless_ticks"] == 0
                and hp["ticks_since_commit"] >= c.transfer_stall_ticks
            ):
                attempt = self._retry_rotation.get(g, 0)
                target = self._ranked_target(info, exclude=lead, attempt=attempt)
                if target:
                    self._retry_rotation[g] = attempt + 1
                    transfer[g] = target
                    transfers += 1
                    self._cooldown_until[g] = round_idx + c.cooldown
        self._emit("kicks", kicks, round_idx, int(kick.sum()))
        self._emit("transfers", transfers, round_idx,
                   [int(g) for g in np.flatnonzero(transfer)])
        return transfer, kick, inspected

    def balance_transfers(
        self,
        weights=None,
        budget: Optional[int] = None,
        round_idx: int = 0,
        transfer: Optional[np.ndarray] = None,
        crashed=None,
    ) -> np.ndarray:
        """Leader-placement rebalance: greedily move the heaviest groups off
        the most-loaded leader peer onto each group's least-loaded other
        alive voter, while the move strictly narrows the pair's load gap.
        Loads are weighted per group (`weights`, default 1s: pass the
        workload's append plane); leader placement is
        kernels.acting_leader_id, downloaded once.  `crashed` (optional
        bool[P, G]) keeps dead peers out of the placement read and out of
        the moves.  Returns the transfer-command plane (int32[G]), extending
        `transfer` if given; budgeted and cooldown-aware like every other
        action."""
        sim = self.sim
        G, P = sim.cfg.n_groups, sim.cfg.n_peers
        budget = self.cfg.max_balance_transfers if budget is None else budget
        out = np.zeros((G,), np.int32) if transfer is None else transfer
        if budget <= 0:
            return out
        st = sim.state
        dev = st.term.device
        if crashed is None:
            crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
        crashed = torch.as_tensor(crashed, dtype=torch.bool, device=dev)
        lead_t = kernels.acting_leader_id(st.state, st.term, crashed)
        lead, vm, dead = (
            t.cpu().numpy() for t in (lead_t, st.voter_mask, crashed)
        )
        if weights is None:
            w = np.ones((G,), np.int64)
        else:
            w = np.asarray(weights, np.int64)
        load = np.zeros((P,), np.int64)
        for p in range(P):
            load[p] = int(w[lead == p + 1].sum())
        moves = 0
        moved_groups = []
        # Heaviest groups first; one pass a cadence (the next cadence reads
        # the placement again).
        for g in np.argsort(-w, kind="stable"):
            if moves >= budget:
                break
            src = int(lead[g])
            if src == 0 or out[g]:
                continue
            if self._cooldown_until.get(int(g), -1) > round_idx:
                continue
            others = [
                q + 1
                for q in range(P)
                if vm[q, g] and q + 1 != src and not dead[q, g]
            ]
            if not others:
                continue
            dst = min(others, key=lambda q: (load[q - 1], q))
            # Strict improvement: moving w[g] must shrink the src/dst gap.
            if load[src - 1] - load[dst - 1] <= int(w[g]):
                continue
            out[g] = dst
            load[src - 1] -= int(w[g])
            load[dst - 1] += int(w[g])
            self._cooldown_until[int(g)] = round_idx + self.cfg.cooldown
            moved_groups.append(int(g))
            moves += 1
        self._emit("transfers", moves, round_idx, {"balance": moved_groups})
        return out

    def _decide_evacuation(
        self, inspected: List[dict], round_idx: int, horizon: int
    ) -> Optional[ReconfigPlan]:
        """The cross-group evacuation policy: when enough of the inspected
        worst groups show the same voter lagging far behind the group's
        highest commit, the remove+add plan for those groups (each group is
        evacuated at most once a run: the Changer chain starts from the
        bootstrap config)."""
        c = self.cfg
        if not c.evacuate or round_idx + 2 >= horizon:
            return None
        sim = self.sim
        P = sim.cfg.n_peers
        vm, lm = (t.cpu().numpy() for t in (sim.state.voter_mask, sim.state.learner_mask))
        suspects: Dict[int, List[int]] = {}
        for info in inspected:
            g = info["group"]
            if g in self._evacuated:
                continue
            if info["health"]["ticks_since_commit"] < c.evac_stall_ticks:
                continue
            cursors = info["peers"]["commit"]
            hi = max(cursors)
            for p in range(P):
                if vm[p, g] and hi - cursors[p] >= c.evac_stall_ticks:
                    suspects.setdefault(p + 1, []).append(g)
        for peer, groups in sorted(suspects.items()):
            groups = [g for g in groups if not vm.T[g].all()]  # a spare must exist
            if len(groups) < c.evac_min_groups:
                continue
            # One uniform spare for the plan: the lowest peer id outside
            # every selected group's config.
            spare = 0
            for q in range(1, P + 1):
                if all(not vm[q - 1, g] and not lm[q - 1, g] for g in groups):
                    spare = q
                    break
            if not spare:
                continue
            voters = [p + 1 for p in range(P) if vm[p, groups[0]]]
            learners = [p + 1 for p in range(P) if lm[p, groups[0]]]
            self._evacuated.update(groups)
            self._emit(
                "evacuations", len(groups), round_idx,
                {"peer": peer, "spare": spare, "groups": groups},
            )
            return ReconfigPlan(
                name=f"autopilot-evac-p{peer}",
                n_peers=P,
                voters=voters,
                learners=learners,
                phases=[
                    ReconfigPhase(rounds=round_idx),
                    ReconfigPhase(
                        rounds=1,
                        op={"enter_joint": [{"remove": peer}, {"add": spare}]},
                        groups=groups,
                    ),
                    ReconfigPhase(
                        rounds=horizon - round_idx - 1,
                        op={"leave_joint": True},
                        groups=groups,
                    ),
                ],
            )
        return None

    # --- the loop ---------------------------------------------------------

    def _runner_for(self, compiled, chaos_compiled, rounds: int):
        """The cadence runner over these schedules, cached by the
        schedules' identity (a runner closes over its schedules, so an
        evacuation's swapped schedule gets a runner of its own); the fused
        arm only at the full cadence length."""
        key = (rounds, id(compiled), id(chaos_compiled))
        hit = self._runners.get(key)
        if hit is None:
            runner = make_cadence_runner(
                self.sim.cfg, compiled, chaos_compiled, rounds,
                fused=self.fused and rounds == self.cfg.cadence,
            )
            # The schedules stay referenced, so their ids stay unique.
            hit = self._runners[key] = (compiled, chaos_compiled, runner)
        return hit[2]

    def run_plan(self, chaos_plan=None, append=None) -> dict:
        """Drive the sim through `chaos_plan` (default: the sim's) with the
        loop on, and return the autopilot report (HealthMonitor.chaos_report
        plus commit_stall_group_rounds, end_counts, actions, and with
        `fused` the fused_rounds, total_rounds and fused_frac).  The sim's
        state and health planes advance in place.

        `append` (optional int[G]) is a per-group workload added to every
        round's chaos-phase append.  Each cadence boundary downloads the
        summary, the explain() columns of the worst groups and, for the
        fused arm, one predicate; nothing else crosses to the host."""
        sim = self.sim
        scfg = sim.cfg
        G, P = scfg.n_groups, scfg.n_peers
        dev = sim.state.term.device
        plan = chaos_plan if chaos_plan is not None else sim._chaos
        if plan is None:
            raise ValueError("no chaos plan; pass one or attach via chaos=")
        if isinstance(plan, chaos_mod.CompiledChaos):
            chaos_compiled = plan
        else:
            chaos_compiled = chaos_mod.compile_plan(plan, G, dev)
        R = chaos_compiled.n_rounds
        compiled = empty_reconfig_schedule(R, P, G, dev)
        append_host = None
        if append is not None:
            append = torch.as_tensor(append).to(device=dev, dtype=I32)
            append_host = append.cpu().numpy().astype(np.int64)
            compiled = compiled._replace(append=compiled.append + append[None, :])
        rst = reconfig_mod.init_reconfig_state(sim.state)
        hl = sim._require_health()
        stats, rstats, safety = reconfig_mod._zero_accumulators(dev)
        csr = torch.zeros((), dtype=I32, device=dev)
        st = sim.state
        bb = sim._bb_args()
        transfer = np.zeros((G,), np.int32)
        kick = np.zeros((P, G), bool)
        done = 0
        fused_rounds = 0
        while done < R:
            seg = min(self.cfg.cadence, R - done)
            runner = self._runner_for(compiled, chaos_compiled, seg)
            out = runner(
                st, hl, rst, stats, rstats, safety, *bb, csr, done,
                torch.from_numpy(transfer).to(dev), torch.from_numpy(kick).to(dev),
            )
            st, hl, rst, stats, rstats, safety = out[:6]
            bb, (csr, seg_fused) = out[6:-2], out[-2:]
            fused_rounds += seg_fused
            sim.state, sim._health = st, hl
            if bb:
                sim._blackbox = bb[0]
            done += seg
            if done >= R:
                break
            # The cadence boundary: the summary crosses to the host and the
            # policy decides the next segment's action planes.
            summary = sim._download_summary(sim._summary(hl.planes))
            if self.monitor is not None:
                self.monitor.record(summary)
            transfer, kick, inspected = self._decide(summary, done)
            if self.cfg.balance:
                # The upcoming round's crash plane keeps the placement read
                # honest: a crashed stale leader is neither counted nor
                # picked as a move's end.
                _, _, crash_next, _ = chaos_mod.schedule_planes(chaos_compiled, done)
                transfer = self.balance_transfers(
                    weights=append_host, round_idx=done, transfer=transfer,
                    crashed=crash_next,
                )
            if self.metrics is not None:
                pending = int((st.transferee > 0).sum())
                self.metrics.health_transfer_pending.set(pending)
            evac = self._decide_evacuation(inspected, done, R)
            if evac is not None:
                compiled = reconfig_mod.compile_plan(evac, G, dev)
                if append is not None:
                    compiled = compiled._replace(append=compiled.append + append[None, :])
                rst = reconfig_mod.init_reconfig_state(st)
        # The tail audit: a final-round apply's mask transition is checked
        # one fold later.
        safety, bb_end = reconfig_mod._tail_audit(safety, st, rst, *bb)
        if bb:
            sim._blackbox = bb_end
        host = torch.cat([stats, safety, csr[None]]).tolist()
        n_stats = stats.numel()
        report = HealthMonitor.chaos_report(
            host[:n_stats], host[n_stats:n_stats + kernels.N_SAFETY], R
        )
        report["commit_stall_group_rounds"] = int(host[-1])
        end = sim._download_summary(sim._summary(sim._health.planes))
        report["end_counts"] = end["counts"]
        report["actions"] = dict(self.actions_taken)
        if self.fused:
            total = R * G
            report["fused_rounds"] = fused_rounds
            report["total_rounds"] = total
            report["fused_frac"] = round(fused_rounds / total, 4)
        if self.monitor is not None:
            self.monitor.record_autopilot(report)
        return report
