"""MultiRaft: the batched host driver for G raft groups on one node, over
the scalar `RawNode` (counterpart of `raft_tpu/multiraft/driver.py`).

A TiKV-style multi-raft node is one peer of each of G groups.  The naive
driver calls `RawNode.tick()` G times per tick interval — an O(G) Python/
branching loop that dominates CPU at 100k groups even when nothing happens.
Here the per-group timer state {state, election_elapsed, heartbeat_elapsed,
randomized_timeout, promotable} lives in host numpy mirrors; each tick()
makes ONE device round-trip (upload the mirrors as one [5, G] int32 stack →
`kernels.tick_kernel` → download ee, hb and the three event masks as one
[5, G] stack) and then touches ONLY the groups whose masks fired
(want_campaign / want_heartbeat / election-timeout boundary).

The tick is plain PyTorch, as the reference's is a `jax.jit` of XLA code
and not a Pallas kernel.  The download is synchronous, so the
`multiraft_tick_sync_seconds` observation spans upload, kernel and
download.  `device=None` means the CUDA card (`platform.resolve_device`,
which raises on a host without one); the tests pass `device="cpu"`.

Consistency contract: the mirrors are authoritative between host events; any
host interaction with a group (messages, proposals, Ready handling) is
bracketed by `_sync_to_node` / `_sync_from_node`, so the scalar RawNode sees
exactly the counters `Raft.tick()` would have produced (reference:
raft.rs:1024-1079 tick semantics, including the leader's election-timeout
boundary effects: check-quorum step and leader-transfer abort,
raft.rs:1056-1065).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..scalar.config import Config, HealthConfig
from ..scalar.eraftpb import Message, MessageType
from ..scalar.errors import RaftError
from ..scalar.raft import StateRole, new_message
from ..scalar.raw_node import RawNode
from ..scalar.storage import Storage
from . import kernels
from .health import HealthMonitor
from .platform import DeviceLike, resolve_device


class MultiRaft:
    """G RawNodes with device-batched tick timers."""

    _HEALTH_EVERY = 128  # ticks between automatic health-summary records

    def __init__(
        self,
        base_config: Config,
        storages: Sequence[Storage],
        group_seeds: Optional[Sequence[int]] = None,
        health: Optional[HealthConfig] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.G = len(storages)
        self.nodes: List[RawNode] = []
        for g, store in enumerate(storages):
            cfg = Config(**{**base_config.__dict__})
            cfg.timeout_seed = (
                group_seeds[g] if group_seeds is not None else g
            )
            self.nodes.append(RawNode(cfg, store))
        self.election_tick = base_config.election_tick
        self.heartbeat_tick = base_config.heartbeat_tick
        # Shared observability plane: the per-group Config copies above all
        # carry the same Metrics reference, so every scalar node reports
        # into one registry; the driver adds its own multiraft_* series.
        self.metrics = base_config.metrics

        # Host-side mirrors [G] (authoritative between host events).
        self._state = np.array([n.raft.state for n in self.nodes], np.int32)
        self._ee = np.array(
            [n.raft.election_elapsed for n in self.nodes], np.int32
        )
        self._hb = np.array(
            [n.raft.heartbeat_elapsed for n in self.nodes], np.int32
        )
        self._rt = np.array(
            [n.raft.randomized_election_timeout for n in self.nodes], np.int32
        )
        self._promotable = np.array(
            [n.raft.promotable for n in self.nodes], bool
        )
        # Consensus-cursor mirrors feeding the health planes (authoritative
        # between host events like the timer mirrors above).
        self._leader = np.array(
            [n.raft.leader_id for n in self.nodes], np.int64
        )
        self._term = np.array([n.raft.term for n in self.nodes], np.int64)
        self._commit = np.array(
            [n.raft.raft_log.committed for n in self.nodes], np.int64
        )

        # Ready-scan short-circuit: groups that MIGHT have readiness.  A
        # RawNode only becomes ready through a host interaction (tick side
        # effects, step/propose/advance, or direct node() access), so every
        # such path marks its group here and ready_groups() probes only the
        # marked set — idle groups cost zero host work per tick.
        self._maybe_ready = set(range(self.G))

        # Fleet-health planes (numpy, this node's view of each group).
        # vote splits are not observable from one peer — that plane lives
        # on the device sim only (docs/OBSERVABILITY.md "Fleet health").
        # Deliberately int64: these are HOST accumulators outside the int32
        # device planes, so they never wrap and need no drain cadence.
        self.health_config = health
        self.health_monitor: Optional[HealthMonitor] = None
        if health is not None:
            health.validate()
            self.health_monitor = HealthMonitor(
                metrics=base_config.metrics,
                recorder_size=health.recorder_size,
                snapshot_fn=self.explain,
            )
            self._h_leaderless = np.zeros(self.G, np.int64)
            self._h_since_commit = np.zeros(self.G, np.int64)
            self._h_term_bumps = np.zeros(self.G, np.int64)
            self._h_prev_commit = self._commit.copy()
            self._h_prev_term = self._term.copy()
            self._h_window_pos = 0
            self._h_ticks = 0
            # Time-to-reelect accounting (the host twin of the chaos
            # engine's device-side MTTR stats — chaos.update_chaos_stats):
            # an episode ends when a leaderless group regains a leader.
            self._h_reelections = 0
            self._h_healed_ticks = 0
            self._h_max_streak = 0
            self._h_leaderless_ticks_total = 0

    # --- host<->mirror row sync ---

    def _sync_to_node(self, g: int) -> None:
        r = self.nodes[g].raft
        r.election_elapsed = int(self._ee[g])
        r.heartbeat_elapsed = int(self._hb[g])

    def _sync_from_node(self, g: int) -> None:
        r = self.nodes[g].raft
        self._state[g] = r.state
        self._ee[g] = r.election_elapsed
        self._hb[g] = r.heartbeat_elapsed
        self._rt[g] = r.randomized_election_timeout
        self._promotable[g] = r.promotable
        self._leader[g] = r.leader_id
        self._term[g] = r.term
        self._commit[g] = r.raft_log.committed

    # --- the batched tick (SURVEY.md §7 kernel k1 in production shape) ---

    def tick(self) -> np.ndarray:
        """Advance every group's logical clock by one tick with a single
        fused device kernel; dispatch tick side effects on the host only for
        fired groups.  Returns the boolean [G] mask of active groups."""
        m = self.metrics
        t0 = time.perf_counter() if m is not None else 0.0
        up = np.stack((self._state, self._ee, self._hb, self._rt,
                       self._promotable)).astype(np.int32)
        state, ee, hb, rt, promotable = torch.from_numpy(up).to(self.device)
        outs = kernels.tick_kernel(state, ee, hb, rt, promotable != 0,
                                   self.election_tick, self.heartbeat_tick)
        # One synchronous download: t0..now spans the full upload -> kernel
        # -> download round trip.
        down = torch.stack([t.to(torch.int32) for t in outs]).cpu().numpy()
        self._ee, self._hb = down[0].copy(), down[1].copy()
        campaign, beat, checkq = down[2] != 0, down[3] != 0, down[4] != 0
        active = campaign | beat | checkq
        if m is not None:
            m.on_driver_tick(
                n_active=int(active.sum()),
                n_campaign=int(campaign.sum()),
                n_beat=int(beat.sum()),
                n_checkq=int(checkq.sum()),
                sync_seconds=time.perf_counter() - t0,
            )
        if not active.any():
            self._update_health()
            return active
        for g in np.nonzero(active)[0]:
            g = int(g)
            self._maybe_ready.add(g)
            node = self.nodes[g]
            r = node.raft
            self._sync_to_node(g)
            # Tick side effects drop only protocol-level step errors, like
            # Raft.tick's internal `let _ = self.step(...)` (reference:
            # raft.rs:1037-1047); real bugs (assertions etc.) propagate.
            if campaign[g]:
                # tick_election fired (reference: raft.rs:1037-1047).
                try:
                    r.step(new_message(0, MessageType.MsgHup, r.id))
                except RaftError:
                    pass
            if checkq[g]:
                # Leader election-timeout boundary (reference:
                # raft.rs:1056-1065): check-quorum + transfer abort.
                if r.check_quorum:
                    try:
                        r.step(new_message(0, MessageType.MsgCheckQuorum, r.id))
                    except RaftError:
                        pass
                if r.state == StateRole.Leader and r.lead_transferee is not None:
                    r.abort_leader_transfer()
            if beat[g] and r.state == StateRole.Leader:
                try:
                    r.step(new_message(0, MessageType.MsgBeat, r.id))
                except RaftError:
                    pass
            self._sync_from_node(g)
        self._update_health()
        return active

    # --- fleet health (this node's per-group view; numpy planes) ---

    def _update_health(self) -> None:
        """Per-tick vectorized health fold over the cursor mirrors (no
        Python per-group loop — this must stay O(G) numpy, not O(G)
        interpreter).  Units are driver TICKS (the sim planes count
        protocol rounds)."""
        hc = self.health_config
        if hc is None:
            return
        has_leader = self._leader != 0
        healed = has_leader & (self._h_leaderless > 0)
        self._h_reelections += int(healed.sum())
        self._h_healed_ticks += int(self._h_leaderless[healed].sum())
        self._h_leaderless = np.where(has_leader, 0, self._h_leaderless + 1)
        self._h_max_streak = max(
            self._h_max_streak, int(self._h_leaderless.max(initial=0))
        )
        self._h_leaderless_ticks_total += int((~has_leader).sum())
        advanced = self._commit > self._h_prev_commit
        self._h_since_commit = np.where(
            advanced, 0, self._h_since_commit + 1
        )
        np.copyto(self._h_prev_commit, self._commit)
        if self._h_window_pos == 0:
            self._h_term_bumps[:] = 0
        self._h_term_bumps += self._term - self._h_prev_term
        np.copyto(self._h_prev_term, self._term)
        self._h_window_pos = (self._h_window_pos + 1) % hc.window
        self._h_ticks += 1
        if (
            self.health_monitor is not None
            and self._h_ticks % self._HEALTH_EVERY == 0
        ):
            self.health_monitor.record(self._health_summary())

    def _health_summary(self) -> Dict[str, object]:
        """The same fixed-size summary shape ClusterSim.health() emits
        (vote-split facts excluded: not observable from one peer)."""
        hc = self.health_config
        assert hc is not None
        lag = self._h_since_commit
        leaderless = self._h_leaderless
        # HEALTH_COUNT_NAMES order (kernels.HS_* indices).
        counts = [
            int((leaderless > 0).sum()),
            int((leaderless >= hc.leaderless_stall_ticks).sum()),
            int((lag >= hc.commit_stall_ticks).sum()),
            int((self._h_term_bumps >= hc.churn_bumps).sum()),
        ]
        bounds = np.asarray(kernels.LAG_BUCKET_BOUNDS, np.int64)
        bucket = (lag[:, None] >= bounds[None, :]).sum(axis=1)
        hist = np.bincount(bucket, minlength=kernels.N_LAG_BUCKETS)
        score = np.maximum(lag, leaderless)
        k = min(hc.topk, self.G)
        order = np.argsort(-score, kind="stable")[:k]
        return HealthMonitor.summary_dict(counts, hist, order, score[order])

    def mttr(self) -> Dict[str, object]:
        """Time-to-reelect facts off the health planes, in driver TICKS
        (the host twin of the chaos engine's per-scenario MTTR report —
        docs/OBSERVABILITY.md "Chaos"): mean leaderless-episode length
        over episodes that ended with a leader regained, plus the worst
        streak and the cumulative leaderless (group, tick) count."""
        if self.health_config is None:
            raise RuntimeError(
                "health disabled; construct MultiRaft with "
                "health=HealthConfig(...)"
            )
        return {
            "mttr_ticks": (
                round(self._h_healed_ticks / self._h_reelections, 3)
                if self._h_reelections
                else None
            ),
            "reelections": self._h_reelections,
            "max_leaderless_streak": self._h_max_streak,
            "leaderless_group_ticks": self._h_leaderless_ticks_total,
        }

    def health(self) -> Dict[str, object]:
        """Current fleet-health summary (requires the health=HealthConfig
        constructor arg); also pushed to the flight recorder."""
        if self.health_config is None:
            raise RuntimeError(
                "health disabled; construct MultiRaft with "
                "health=HealthConfig(...)"
            )
        summary = self._health_summary()
        if self.health_monitor is not None:
            self.health_monitor.record(summary)
        return summary

    def explain(self, group_id: int) -> Dict[str, object]:
        """Post-mortem for one group: health-plane row + this peer's
        consensus cursors (worst-offender snapshots in the flight recorder
        come through here)."""
        r = self.nodes[group_id].raft
        out: Dict[str, object] = {
            "group": int(group_id),
            "term": int(r.term),
            "state": int(r.state),
            "leader_id": int(r.leader_id),
            "commit": int(r.raft_log.committed),
            "last_index": int(r.raft_log.last_index()),
        }
        if self.health_config is not None:
            out["health"] = {
                "leaderless_ticks": int(self._h_leaderless[group_id]),
                "ticks_since_commit": int(self._h_since_commit[group_id]),
                "term_bumps_in_window": int(self._h_term_bumps[group_id]),
            }
        return out

    # --- host-side per-group interactions (all bracketed by sync) ---

    def _host_op(self, g: int, fn: Callable[[RawNode], object]):
        self._sync_to_node(g)
        self._maybe_ready.add(g)
        try:
            return fn(self.nodes[g])
        finally:
            self._sync_from_node(g)

    def step(self, g: int, m: Message) -> None:
        self._host_op(g, lambda n: n.step(m))

    def step_batch(self, msgs: Iterable[Tuple[int, Message]]) -> None:
        """Deliver a batch of (group, message) pairs (the DCN inbox path,
        SURVEY.md §5.8b)."""
        by_group: Dict[int, List[Message]] = {}
        for g, m in msgs:
            by_group.setdefault(g, []).append(m)
        for g in sorted(by_group):
            self._sync_to_node(g)
            self._maybe_ready.add(g)
            for m in by_group[g]:
                # Inbox delivery ignores protocol step errors only (the DCN
                # receive path mirrors the harness pump's discipline).
                try:
                    self.nodes[g].step(m)
                except RaftError:
                    pass
            self._sync_from_node(g)

    def propose(self, g: int, context: bytes, data: bytes) -> None:
        self._host_op(g, lambda n: n.propose(context, data))

    def campaign(self, g: int) -> None:
        self._host_op(g, lambda n: n.campaign())

    def transfer_leader(self, g: int, transferee: int) -> None:
        """Begin transferring group `g`'s leadership to peer `transferee`
        (RawNode::transfer_leader — the autopilot's admin action on the
        host driver path; the batched sim's twin is
        sim.step(transfer_propose=))."""
        self._host_op(g, lambda n: n.transfer_leader(transferee))

    def transfer_pending(self) -> int:
        """Groups with a leader transfer in flight (this node leading with
        lead_transferee set); also published as the
        health_groups_transfer_pending gauge when metrics are enabled."""
        pending = sum(
            1 for n in self.nodes if n.raft.lead_transferee is not None
        )
        m = self.metrics
        if m is not None:
            m.health_transfer_pending.set(pending)
        return pending

    def autopilot_report(self) -> Dict[str, object]:
        """The driver-side autopilot surface: current transfer-pending
        count, the MTTR facts (when health is on), and the most recent
        autopilot flight-recorder entry from the attached monitor (the
        batched Autopilot records its run reports there)."""
        out: Dict[str, object] = {
            "transfer_pending": self.transfer_pending(),
        }
        if self.health_config is not None:
            out["mttr"] = self.mttr()
        if self.health_monitor is not None:
            for entry in reversed(self.health_monitor.summary_ring()):
                if "autopilot" in entry:
                    out["last_run"] = entry["autopilot"]
                    break
        return out

    def has_ready(self, g: int) -> bool:
        return self.nodes[g].has_ready()

    def ready_groups(self) -> List[int]:
        """Groups with pending readiness.

        Short-circuited by the `_maybe_ready` dirty set: only groups some
        host interaction touched since they last probed not-ready are
        scanned — the device fired-masks already tell the tick which groups
        those are, so a quiescent fleet costs ZERO per-group host work here
        instead of an O(G) has_ready() sweep.  The scanned/skipped split is
        recorded on the metrics plane (the skip ratio)."""
        dirty = self._maybe_ready
        out: List[int] = []
        still: set = set()
        for g in sorted(dirty):
            if self.nodes[g].has_ready():
                out.append(g)
                still.add(g)
        m = self.metrics
        if m is not None:
            m.on_ready_scan(scanned=len(dirty), skipped=self.G - len(dirty))
        self._maybe_ready = still
        return out

    def ready(self, g: int):
        return self._host_op(g, lambda n: n.ready())

    def advance(self, g: int, rd):
        return self._host_op(g, lambda n: n.advance(rd))

    def advance_apply(self, g: int) -> None:
        self._host_op(g, lambda n: n.advance_apply())

    def node(self, g: int) -> RawNode:
        # Handing out the RawNode lets the caller mutate it behind our
        # back, so conservatively mark the group for the next ready scan.
        self._maybe_ready.add(g)
        return self.nodes[g]

    # --- batched introspection (SURVEY.md §5.5 MultiRaftStatus) ---

    def status(self) -> Dict[str, object]:
        states = self._state
        commits = np.array(
            [n.raft.raft_log.committed for n in self.nodes], np.int64
        )
        terms = np.array([n.raft.term for n in self.nodes], np.int64)
        out: Dict[str, object] = {
            "n_groups": self.G,
            "n_leaders": int((states == StateRole.Leader).sum()),
            "n_candidates": int((states == StateRole.Candidate).sum()),
            "min_commit": int(commits.min()) if self.G else 0,
            "total_commit": int(commits.sum()),
            "max_term": int(terms.max()) if self.G else 0,
        }
        if self.metrics is not None:
            out["metrics"] = self.metrics_snapshot()
        if self.health_monitor is not None:
            # The forensics surface: incidents the attached
            # monitor has recorded — from a device black box
            # (ClusterSim's drain) or any other record_incident caller —
            # summarized as cumulative per-slot counts plus the most
            # recent incident, so an operator's status poll can never
            # miss a tripped invariant.
            incidents = self.health_monitor.incidents()
            counts: Dict[str, int] = {}
            for inc in incidents:
                slot = inc.get("slot", "unknown")
                counts[slot] = max(counts.get(slot, 0), inc.get("count", 0))
            out["forensics"] = {
                "incidents": len(incidents),
                "counts": counts,
                "last": incidents[-1] if incidents else None,
            }
        return out

    def metrics_snapshot(self) -> Dict[str, float]:
        """Flat {sample_name: value} view of the shared registry (empty when
        metrics are disabled); `self.metrics.registry.expose()` gives the
        Prometheus text form."""
        if self.metrics is None:
            return {}
        return self.metrics.registry.snapshot()
