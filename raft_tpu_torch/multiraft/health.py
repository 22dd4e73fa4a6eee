"""HealthMonitor: the host-side consumer of fleet-health summaries.

Counterpart of `raft_tpu/multiraft/health.py` (:35-399): the
summary formatter, `record`, the chaos scenario report `chaos_report` and
`record_scenario`, the reconfig scenario report `reconfig_stall_groups`,
`reconfig_report` and `record_reconfig`, the autopilot report's
`record_autopilot`, the client-read report's `record_reads`, the
black box's `record_incident` and `incidents`, `last`,
`summary_ring` and `__len__`.  The device planes (kernels.HP_* rows, maintained by sim.step)
reduce on their device to one fixed-size summary dict::

    {"counts": {"leaderless": n, "stalled_leaderless": n,
                "commit_stalled": n, "churning": n},
     "lag_hist": [kernels.N_LAG_BUCKETS counts],
     "worst": [{"group": id, "score": s}, ...]}

The MultiRaft driver's numpy planes (driver.py) reduce to the same dict.
This module is where those summaries land on the host: the monitor hands
each one to `metrics` (a scalar.metrics.Metrics, or any object with
`on_health_summary(summary)` and `trace(event, **fields)`), and keeps a
fixed-size ring of recent summaries with a state snapshot of each worst
group for post-mortems (ClusterSim.explain and MultiRaft.explain install
themselves as the snapshot hook).  Summaries arrive as plain host dicts;
nothing here touches a device tensor.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from .kernels import HEALTH_COUNT_NAMES, SAFETY_NAMES

__all__ = ["HealthMonitor"]


class HealthMonitor:
    """Flight recorder and metrics bridge for health summaries.

    metrics:       optional scalar.metrics.Metrics (or any object with
                   on_health_summary(summary) and trace(event, **fields));
                   each recorded summary is published and traced through
                   it.
    recorder_size: ring capacity.
    snapshot_fn:   optional group_id -> dict hook; when set, worst-offender
                   groups with a non-zero score get a state snapshot stored
                   beside the summary.
    """

    def __init__(
        self,
        metrics=None,
        recorder_size: int = 64,
        snapshot_fn: Optional[Callable[[int], dict]] = None,
    ):
        self.metrics = metrics
        self.snapshot_fn = snapshot_fn
        self._summary_ring: Deque[dict] = deque(maxlen=recorder_size)
        self._seq = 0
        self._lock = threading.Lock()
        # Per safety slot, the offender count last folded into the metric.
        self._incident_seen: Dict[str, int] = {}

    @staticmethod
    def summary_dict(counts, lag_hist, worst_ids, worst_scores) -> dict:
        """The summary shape (module docstring) from the four reduction
        vectors, in kernels.health_summary's return order: the one
        formatter every producer goes through."""
        return {
            "counts": dict(zip(HEALTH_COUNT_NAMES, (int(v) for v in counts))),
            "lag_hist": [int(v) for v in lag_hist],
            "worst": [
                {"group": int(g), "score": int(s)}
                for g, s in zip(worst_ids, worst_scores)
            ],
        }

    def record(self, summary: dict) -> dict:
        """Fold one summary into the ring, the metrics and the trace;
        returns the ring entry (with its seq, ts and snapshots)."""
        snapshots: Dict[int, dict] = {}
        fn = self.snapshot_fn
        if fn is not None:
            for w in summary.get("worst", ()):
                if w["score"] > 0:
                    snapshots[w["group"]] = fn(w["group"])
        with self._lock:
            entry = {"seq": self._seq, "ts": time.time(), "summary": summary}
            if snapshots:
                entry["worst_snapshots"] = snapshots
            self._seq += 1
            self._summary_ring.append(entry)
        m = self.metrics
        if m is not None:
            m.on_health_summary(summary)
            counts = summary.get("counts", {})
            m.trace("health.summary", **counts)
            if counts.get("stalled_leaderless", 0) or counts.get(
                "commit_stalled", 0
            ):
                m.trace(
                    "health.stall",
                    stalled_leaderless=counts.get("stalled_leaderless", 0),
                    commit_stalled=counts.get("commit_stalled", 0),
                    worst=summary.get("worst", []),
                )
            if counts.get("churning", 0):
                m.trace("health.churn", churning=counts.get("churning", 0))
        return entry

    @staticmethod
    def chaos_report(stats, safety, rounds: int) -> dict:
        """Per-scenario chaos summary off the run's accumulators (host
        sequences of ints): `stats` the [chaos.N_CHAOS_STATS] time-to-
        reelect facts (CS_* indices), `safety` the [kernels.N_SAFETY]
        violation counts (SV_* indices, all zero on a correct run), `rounds`
        the rounds the plan ran.  Returns the scenario-summary dict that
        bench.py --chaos writes::

            {"rounds": R,
             "mttr_rounds": mean leaderless-episode length (None when no
                            episode ended),
             "reelections": episodes that ended with a leader regained,
             "max_leaderless_streak": worst streak observed anywhere,
             "leaderless_group_rounds": leaderless (group, round) pairs,
             "safety": {"dual_leader": 0, ...}}
        """
        from .chaos import (
            CS_HEALED_ROUNDS,
            CS_LEADERLESS_ROUNDS,
            CS_MAX_STREAK,
            CS_REELECTIONS,
        )

        reelections = int(stats[CS_REELECTIONS])
        healed = int(stats[CS_HEALED_ROUNDS])
        return {
            "rounds": int(rounds),
            "mttr_rounds": (
                round(healed / reelections, 3) if reelections else None
            ),
            "reelections": reelections,
            "max_leaderless_streak": int(stats[CS_MAX_STREAK]),
            "leaderless_group_rounds": int(stats[CS_LEADERLESS_ROUNDS]),
            "safety": {
                name: int(v) for name, v in zip(SAFETY_NAMES, safety)
            },
        }

    def record_autopilot(self, report: dict) -> dict:
        """Fold an autopilot run report (autopilot.Autopilot.run_plan's
        shape: chaos_report plus commit_stall_group_rounds, end_counts and
        actions) into the ring and the trace; a nonzero safety count raises
        an `autopilot.safety` event, so a healing run can be audited from
        the trace alone."""
        with self._lock:
            entry = {"seq": self._seq, "ts": time.time(), "autopilot": report}
            self._seq += 1
            self._summary_ring.append(entry)
        m = self.metrics
        if m is not None:
            m.trace(
                "autopilot.scenario",
                rounds=report.get("rounds", 0),
                mttr_rounds=report.get("mttr_rounds"),
                commit_stall_group_rounds=report.get(
                    "commit_stall_group_rounds", 0
                ),
                actions=report.get("actions", {}),
            )
            if any(report.get("safety", {}).values()):
                m.trace("autopilot.safety", **report["safety"])
        return entry

    def record_reads(self, report: dict) -> dict:
        """Fold a client-read workload report (workload.read_report's
        shape) into the ring and the trace; a nonzero safety count, the
        linearizability slots included, raises a `reads.safety` event so a
        stale read can never scroll by silently."""
        with self._lock:
            entry = {"seq": self._seq, "ts": time.time(), "reads": report}
            self._seq += 1
            self._summary_ring.append(entry)
        m = self.metrics
        if m is not None:
            m.trace(
                "reads.scenario",
                rounds=report.get("rounds", 0),
                reads_issued=report.get("reads_issued", 0),
                served_lease=report.get("served_lease", 0),
                served_quorum=report.get("served_quorum", 0),
                degraded_serves=report.get("degraded_serves", 0),
                read_p50=report.get("read_p50", -1),
                read_p99=report.get("read_p99", -1),
            )
            if any(report.get("safety", {}).values()):
                m.trace("reads.safety", **report["safety"])
        return entry

    def record_scenario(self, report: dict) -> dict:
        """Fold a chaos scenario report (chaos_report's shape) into the ring
        and the trace; safety violations raise a `chaos.safety` trace event
        so they can never scroll by silently."""
        with self._lock:
            entry = {"seq": self._seq, "ts": time.time(), "chaos": report}
            self._seq += 1
            self._summary_ring.append(entry)
        m = self.metrics
        if m is not None:
            m.trace(
                "chaos.scenario",
                rounds=report.get("rounds", 0),
                mttr_rounds=report.get("mttr_rounds"),
                reelections=report.get("reelections", 0),
                max_leaderless_streak=report.get("max_leaderless_streak", 0),
            )
            if any(report.get("safety", {}).values()):
                m.trace("chaos.safety", **report["safety"])
        return entry

    @staticmethod
    def reconfig_stall_groups(
        outgoing_mask, since_commit, election_tick: int,
        stall_timeouts: int = 4, topk: int = 8,
    ):
        """The reconfig-stall rule, on host arrays: a group still inside a
        joint config (outgoing half non-empty, `outgoing_mask` bool[P, G])
        whose commit has been flat (`since_commit`, the HP_SINCE_COMMIT
        plane, int[G]) for `stall_timeouts * election_tick` rounds.
        Returns (stalled_count, worst_group_ids), worst ranked by staleness
        as the reference ranks it (numpy's argsort of the masked staleness,
        reversed), capped at `topk`."""
        joint = np.any(np.asarray(outgoing_mask), axis=0)
        since = np.asarray(since_commit)
        stuck = joint & (since >= stall_timeouts * election_tick)
        n_stuck = int(stuck.sum())
        order = np.argsort(np.where(stuck, since, -1))[::-1]
        return n_stuck, [int(g) for g in order[: min(n_stuck, topk)]]

    @staticmethod
    def reconfig_report(
        stats, rstats, safety, rounds: int, stalled_groups: int,
        stalled_worst=(),
    ) -> dict:
        """Per-scenario reconfig summary off the run's accumulators (host
        sequences of ints): `stats` the [chaos.N_CHAOS_STATS] MTTR facts,
        `rstats` the [reconfig.N_RECONFIG_STATS] op-protocol counts (RC_*:
        proposals, applies, retries, joint group-rounds), `safety` the
        [kernels.N_SAFETY] violation counts with the joint-window slots,
        `rounds` the rounds run, and the stalled groups from
        reconfig_stall_groups.  Returns the dict bench.py --reconfig
        writes."""
        from .chaos import CS_HEALED_ROUNDS, CS_MAX_STREAK, CS_REELECTIONS
        from .reconfig import RECONFIG_STAT_NAMES

        reelections = int(stats[CS_REELECTIONS])
        healed = int(stats[CS_HEALED_ROUNDS])
        return {
            "rounds": int(rounds),
            **{name: int(v) for name, v in zip(RECONFIG_STAT_NAMES, rstats)},
            "mttr_rounds": (
                round(healed / reelections, 3) if reelections else None
            ),
            "reelections": reelections,
            "max_leaderless_streak": int(stats[CS_MAX_STREAK]),
            "reconfig_stalled_groups": int(stalled_groups),
            "reconfig_stalled_worst": [int(g) for g in stalled_worst],
            "safety": {
                name: int(v) for name, v in zip(SAFETY_NAMES, safety)
            },
        }

    def record_reconfig(self, report: dict) -> dict:
        """Fold a reconfig scenario report (reconfig_report's shape) into
        the ring and the trace; stalled groups raise a
        `health.reconfig_stall` event and safety violations a
        `reconfig.safety` event.  A metrics object with a
        `health_reconfig_stalled` gauge gets the stalled count set."""
        with self._lock:
            entry = {"seq": self._seq, "ts": time.time(), "reconfig": report}
            self._seq += 1
            self._summary_ring.append(entry)
        m = self.metrics
        if m is not None:
            stalled = report.get("reconfig_stalled_groups", 0)
            gauge = getattr(m, "health_reconfig_stalled", None)
            if gauge is not None:
                gauge.set(stalled)
            m.trace(
                "reconfig.scenario",
                rounds=report.get("rounds", 0),
                proposals=report.get("proposals", 0),
                ops_applied=report.get("ops_applied", 0),
                retries=report.get("retries", 0),
                joint_group_rounds=report.get("joint_group_rounds", 0),
            )
            if stalled:
                m.trace(
                    "health.reconfig_stall",
                    stalled=stalled,
                    worst=report.get("reconfig_stalled_worst", []),
                )
            if any(report.get("safety", {}).values()):
                m.trace("reconfig.safety", **report["safety"])
        return entry

    def record_incident(self, incident: dict) -> dict:
        """Fold a black-box incident ({"slot": name, "count": n,
        "offenders": [{"group", "round"}, ...]}, ClusterSim's drain report
        of one safety slot) into the ring and the trace as a
        `forensics.incident` event.  A metrics object with a
        `safety_incidents` counter family gets its {slot} counter bumped by
        the offenders new since the slot was last reported (the counts
        arrive cumulative)."""
        with self._lock:
            entry = {"seq": self._seq, "ts": time.time(), "incident": incident}
            self._seq += 1
            self._summary_ring.append(entry)
            # The seen-count read-modify-write shares the ring's lock: two
            # reporters of one slot must not both count the same offenders.
            prev = self._incident_seen.get(incident["slot"], 0)
            delta = max(0, incident.get("count", 0) - prev)
            self._incident_seen[incident["slot"]] = max(prev, incident.get("count", 0))
        m = self.metrics
        if m is not None:
            counter = getattr(m, "safety_incidents", None)
            if counter is not None and delta:
                counter.labels(slot=incident["slot"]).inc(delta)
            m.trace(
                "forensics.incident",
                slot=incident["slot"],
                count=incident.get("count", 0),
                offenders=incident.get("offenders", []),
            )
        return entry

    def incidents(self) -> List[dict]:
        """Oldest-to-newest black-box incidents still in the ring."""
        with self._lock:
            return [e["incident"] for e in self._summary_ring if "incident" in e]

    def last(self) -> Optional[dict]:
        """Most recent ring entry, or None."""
        with self._lock:
            return self._summary_ring[-1] if self._summary_ring else None

    def summary_ring(self) -> List[dict]:
        """Oldest-to-newest copy of the ring (health summaries and chaos
        scenario reports)."""
        with self._lock:
            return list(self._summary_ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._summary_ring)
