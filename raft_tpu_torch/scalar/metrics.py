"""Unified metrics + structured tracing for raft-tpu (SURVEY.md §5.1: the
reference's observability is structured slog tracing + Criterion; this module
is our equivalent counter plane for the scalar core, the MultiRaft driver,
and — via the device counter plane in `raft_tpu_torch.multiraft.kernels` — the
batched sim).

Zero dependencies beyond the standard library.  Three pieces:

* `Registry` — counters / gauges / histograms with optional labels and
  Prometheus text exposition (`expose()`); `snapshot()` returns a flat dict
  for programmatic scraping (`MultiRaft.metrics_snapshot()`).
* `EventTracer` — JSONL structured event tracing.  Every event is one JSON
  object per line with a monotonic `seq`, an `event` name, and arbitrary
  tags (group, id, term, ...).  The sink is a file path, a file-like object,
  or a plain list (tests).
* `Metrics` — the facade the consensus core is instrumented against.  An
  instance is attached to `Config.metrics`; every hot-path hook in
  `raft.py` / `raw_node.py` / `multiraft/driver.py` is guarded by a single
  `if self.metrics is not None` branch, so the disabled path (the default)
  costs exactly one predictable branch and no allocation.

Threading contract: sample mutation (inc/set/observe) is **single-writer**
— the scalar core and the MultiRaft driver are single-threaded, and a
per-sample lock would tax every hot-path event for a shape the library
doesn't have.  Scraping (`expose()`/`snapshot()`/`total()`) IS safe from
another thread while the writer runs: registration and labelset creation
are lock-guarded, and the scrape paths iterate point-in-time copies.

The device-side counter plane (campaigns fired, heartbeats emitted,
elections won, commit entries advanced) lives in `SimState`-adjacent arrays
summed inside the device step — see `raft_tpu_torch.multiraft.sim.ClusterSim` and
the `CTR_*` indices in `raft_tpu_torch.multiraft.kernels`.  Its parity contract
against the scalar counters here is asserted by
`tests/test_torch_metrics.py`.
"""

from __future__ import annotations

import io
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "EventTracer",
    "Metrics",
    "DEFAULT_LATENCY_BUCKETS",
]

# Default histogram bounds for host<->device latencies (seconds).
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3, 100e-3, 250e-3, 1.0,
)

def _role_names() -> Dict[int, str]:
    """StateRole codes -> names, imported lazily (module-load order: the
    package __init__ pulls metrics in before raft)."""
    from .raft import StateRole

    return dict(StateRole._NAMES)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in zip(labelnames, labelvalues)
    )
    return "{" + pairs + "}"


class Counter:
    """Monotonically increasing counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters can only increase")
        self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bound histogram (cumulative buckets at exposition time)."""

    __slots__ = ("bounds", "bucket_counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        b = sorted(bounds)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds: Tuple[float, ...] = tuple(b)
        # One slot per finite bound plus the +Inf overflow slot.
        self.bucket_counts: List[int] = [0] * (len(b) + 1)
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le_bound, cumulative_count), ...] ending with (+inf, count)."""
        out: List[Tuple[float, int]] = []
        running = 0
        for bound, c in zip(self.bounds, self.bucket_counts):
            running += c
            out.append((bound, running))
        out.append((float("inf"), self.count))
        return out


_KIND_NAMES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class _Family:
    """One metric name with a fixed label schema and per-labelset children.

    With no labels the family proxies inc/set/observe straight to its single
    implicit child, so call sites read `fam.inc()` either way.
    """

    def __init__(
        self,
        name: str,
        help: str,
        kind: type,
        labelnames: Sequence[str],
        histogram_bounds: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._bounds = histogram_bounds
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _new_child(self):
        if self.kind is Histogram:
            return Histogram(self._bounds or DEFAULT_LATENCY_BUCKETS)
        return self.kind()

    def labels(self, *labelvalues, **labelkv):
        if labelkv:
            if labelvalues:
                raise ValueError("pass label values positionally OR by name")
            try:
                labelvalues = tuple(str(labelkv[k]) for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} (schema {self.labelnames})"
                ) from None
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {labelvalues}"
            )
        child = self._children.get(labelvalues)
        if child is None:
            # Double-checked creation: one Metrics instance is shared across
            # every node of a deployment, so two threads can first-touch the
            # same labelset concurrently; without the lock one child would
            # silently shadow the other and its increments would vanish.
            with self._lock:
                child = self._children.get(labelvalues)
                if child is None:
                    child = self._new_child()
                    self._children[labelvalues] = child
        return child

    # --- no-label conveniences ---

    def _solo(self):
        return self.labels()

    def inc(self, n: float = 1) -> None:
        self._solo().inc(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    @property
    def value(self) -> float:
        return self._solo().value

    def total(self) -> float:
        """Sum over all label children (counters/gauges)."""
        return sum(c.value for c in list(self._children.values()))


class Registry:
    """Named metric families; thread-safe registration, idempotent by name."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(
        self,
        name: str,
        help: str,
        kind: type,
        labelnames: Sequence[str],
        histogram_bounds: Optional[Sequence[float]] = None,
    ) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind is not kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"kind/label schema"
                    )
                return fam
            fam = _Family(name, help, kind, labelnames, histogram_bounds)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create(name, help, Counter, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create(name, help, Gauge, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> _Family:
        return self._get_or_create(name, help, Histogram, labelnames, buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    @staticmethod
    def _fmt_value(v: float) -> str:
        if isinstance(v, int):
            return str(v)
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    @staticmethod
    def _fmt_le(bound: float) -> str:
        return "+Inf" if bound == float("inf") else Registry._fmt_value(bound)

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out = io.StringIO()
        # list() copies: a writer thread may first-touch a labelset while a
        # scrape thread iterates (see the module threading contract).
        for name, fam in list(self._families.items()):
            if fam.help:
                out.write(f"# HELP {name} {fam.help}\n")
            out.write(f"# TYPE {name} {_KIND_NAMES[fam.kind]}\n")
            for labelvalues, child in list(fam._children.items()):
                labels = _format_labels(fam.labelnames, labelvalues)
                if fam.kind is Histogram:
                    for bound, cum in child.cumulative():
                        le = _format_labels(
                            fam.labelnames + ("le",),
                            labelvalues + (self._fmt_le(bound),),
                        )
                        out.write(f"{name}_bucket{le} {cum}\n")
                    out.write(
                        f"{name}_sum{labels} {self._fmt_value(child.sum)}\n"
                    )
                    out.write(f"{name}_count{labels} {child.count}\n")
                else:
                    out.write(
                        f"{name}{labels} {self._fmt_value(child.value)}\n"
                    )
        return out.getvalue()

    def snapshot(self) -> Dict[str, float]:
        """Flat {sample_name: value} dict (histograms expose _sum/_count)."""
        out: Dict[str, float] = {}
        for name, fam in list(self._families.items()):
            for labelvalues, child in list(fam._children.items()):
                labels = _format_labels(fam.labelnames, labelvalues)
                if fam.kind is Histogram:
                    out[f"{name}_sum{labels}"] = child.sum
                    out[f"{name}_count{labels}"] = child.count
                else:
                    out[f"{name}{labels}"] = child.value
        return out


class EventTracer:
    """Structured JSONL event sink.

    sink: a file path (opened lazily, line-buffered), a file-like object
    with .write(), or a list (events appended as dicts — the test sink).
    Every event carries a monotonic `seq` so interleavings reconstruct.
    """

    def __init__(self, sink: Union[str, list, io.TextIOBase, object]):
        self._sink = sink
        self._fh = None
        self._seq = 0
        self._lock = threading.Lock()

    def emit(self, event: str, **fields) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
            record = {"seq": seq, "ts": time.time(), "event": event}
            record.update(fields)
            if isinstance(self._sink, list):
                self._sink.append(record)
                return
            fh = self._fh
            if fh is None:
                if isinstance(self._sink, str):
                    fh = open(self._sink, "a", buffering=1)
                else:
                    fh = self._sink
                self._fh = fh
            fh.write(json.dumps(record, separators=(",", ":")) + "\n")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and isinstance(self._sink, str):
                self._fh.close()
            self._fh = None


class Metrics:
    """The instrumentation facade attached to `Config.metrics`.

    One instance is shared by every node of a deployment (the MultiRaft
    driver's per-group Config copies all carry the same reference), so the
    registry aggregates across groups while traces stay per-group tagged.
    All handles are pre-bound at construction: the per-event cost is one
    list index + one float add.
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        tracer: Optional[EventTracer] = None,
    ):
        from .eraftpb import MessageType  # local import: keep module light

        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer
        self._role_names = _role_names()
        r = self.registry

        sent = r.counter(
            "raft_msgs_sent_total", "Messages queued for send", ("type",)
        )
        recv = r.counter(
            "raft_msgs_received_total", "Messages stepped", ("type",)
        )
        # Index by int(MessageType) — values are contiguous 0..18.
        self._sent_by_type = [sent.labels(type=t.name) for t in MessageType]
        self._recv_by_type = [recv.labels(type=t.name) for t in MessageType]

        trans = r.counter(
            "raft_state_transitions_total", "Role transitions", ("to",)
        )
        self._trans_by_role = [
            trans.labels(to=self._role_names[i])
            for i in sorted(self._role_names)
        ]
        self.campaigns = r.counter(
            "raft_campaigns_total", "Campaigns started", ("type",)
        )
        self.votes_granted = r.counter(
            "raft_votes_granted_total", "Votes granted", ("type",)
        )
        self.elections_won = r.counter(
            "raft_elections_won_total", "become_leader transitions"
        )
        self.beats = r.counter(
            "raft_beats_total", "MsgBeat heartbeats fired at leaders"
        )
        self.commit_advances = r.counter(
            "raft_commit_advances_total", "Commit-index advance events"
        )
        self.commit_entries = r.counter(
            "raft_commit_entries_total", "Total entries newly committed"
        )
        self.appends_rejected = r.counter(
            "raft_appends_rejected_total", "MsgAppend probes rejected"
        )
        self.snapshots_sent = r.counter(
            "raft_snapshots_sent_total", "Snapshots prepared for send"
        )
        self.conf_changes = r.counter(
            "raft_conf_changes_total", "Conf changes applied"
        )
        self.ready_cycles = r.counter(
            "raft_ready_total", "Ready structs harvested"
        )
        self.advance_cycles = r.counter(
            "raft_advance_total", "Ready structs advanced"
        )
        self.must_sync = r.counter(
            "raft_must_sync_total", "Readys requiring synchronous persistence"
        )

        # MultiRaft driver plane.
        self.driver_ticks = r.counter(
            "multiraft_ticks_total", "Batched driver ticks"
        )
        self.driver_active_groups = r.counter(
            "multiraft_active_groups_total",
            "Groups whose tick fired a host-side event",
        )
        self.driver_campaigns_fired = r.counter(
            "multiraft_campaign_events_total",
            "Per-tick campaign mask population",
        )
        self.driver_beats_fired = r.counter(
            "multiraft_heartbeat_events_total",
            "Per-tick heartbeat mask population",
        )
        self.driver_checkq_fired = r.counter(
            "multiraft_check_quorum_events_total",
            "Per-tick leader election-timeout boundary mask population",
        )
        self.driver_last_active = r.gauge(
            "multiraft_last_tick_active_groups",
            "Active-group mask population of the most recent tick",
        )
        self.driver_sync_seconds = r.histogram(
            "multiraft_tick_sync_seconds",
            "Host<->device round-trip latency of the batched tick",
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self.ready_scan_scanned = r.counter(
            "multiraft_ready_scan_groups_scanned_total",
            "Groups actually probed by ready_groups() (the dirty set)",
        )
        self.ready_scan_skipped = r.counter(
            "multiraft_ready_scan_groups_skipped_total",
            "Idle groups ready_groups() skipped without any host work",
        )

        # Fleet-health plane (multiraft/health.py HealthMonitor summaries).
        self.health_summaries = r.counter(
            "health_summaries_total", "Health summaries recorded"
        )
        self.health_leaderless = r.gauge(
            "health_groups_leaderless", "Groups currently without a leader"
        )
        self.health_stalled_leaderless = r.gauge(
            "health_groups_stalled_leaderless",
            "Groups leaderless at/over the stall threshold",
        )
        self.health_commit_stalled = r.gauge(
            "health_groups_commit_stalled",
            "Groups with a flat commit index at/over the stall threshold",
        )
        self.health_churning = r.gauge(
            "health_groups_churning",
            "Groups with term bumps in window at/over the churn threshold",
        )
        self.health_worst_score = r.gauge(
            "health_worst_group_score",
            "Worst-offender score (max of commit lag and leaderless ticks)",
        )
        # The device reduces commit lag into fixed buckets already, so this
        # is a labeled gauge family (a point-in-time distribution), not a
        # Histogram (which accumulates observations).
        self.health_commit_lag = r.gauge(
            "health_commit_lag_groups",
            "Groups per commit-lag bucket (lower bound label, ticks)",
            ("ge",),
        )
        self.health_reconfig_stalled = r.gauge(
            "health_groups_reconfig_stalled",
            "Groups sitting in a joint config with a stalled commit "
            "(HealthMonitor.record_reconfig's stall detection)",
        )

        # Autopilot plane (multiraft/autopilot.py): the closed control
        # loop's issued actions and the transfer protocol's in-flight
        # gauge.
        self.autopilot_actions = r.counter(
            "multiraft_autopilot_actions_total",
            "Autopilot heal actions issued, by kind "
            "(kicks / transfers / evacuations)",
            ("kind",),
        )
        self.health_transfer_pending = r.gauge(
            "health_groups_transfer_pending",
            "Groups with a leader transfer currently pending "
            "(lead_transferee set at the acting leader)",
        )

        # Forensics plane (multiraft/forensics.py): offender
        # groups captured by the device black box, by safety slot —
        # HealthMonitor.record_incident increments by the newly-captured
        # delta, so the counter tracks cumulative distinct offenders.
        self.safety_incidents = r.counter(
            "multiraft_safety_incidents_total",
            "Safety-invariant offender groups captured by the black-box "
            "forensics layer, by slot",
            ("slot",),
        )

    # --- tracing ---

    def trace(self, event: str, **fields) -> None:
        if self.tracer is not None:
            self.tracer.emit(event, **fields)

    # --- scalar-core hooks (raft.py) ---

    def on_send(self, msg_type: int) -> None:
        self._sent_by_type[msg_type].inc()

    def on_recv(self, msg_type: int) -> None:
        self._recv_by_type[msg_type].inc()

    def on_transition(self, to_role: int, group: int, id: int, term: int) -> None:
        self._trans_by_role[to_role].inc()
        if self.tracer is not None:
            self.tracer.emit(
                "state_transition",
                group=group,
                id=id,
                term=term,
                to=self._role_names[to_role],
            )

    def on_campaign(self, kind: str, group: int, id: int, term: int) -> None:
        self.campaigns.labels(type=kind).inc()
        if self.tracer is not None:
            self.tracer.emit(
                "campaign", group=group, id=id, term=term, type=kind
            )

    def on_vote_grant(
        self, pre: bool, group: int, id: int, term: int, candidate: int
    ) -> None:
        self.votes_granted.labels(type="PreVote" if pre else "Vote").inc()
        if self.tracer is not None:
            self.tracer.emit(
                "vote_grant",
                group=group,
                id=id,
                term=term,
                candidate=candidate,
                pre=pre,
            )

    def on_election_won(self, group: int, id: int, term: int) -> None:
        self.elections_won.inc()

    def on_beat(self) -> None:
        self.beats.inc()

    def on_commit_advance(
        self, group: int, id: int, term: int, old: int, new: int
    ) -> None:
        self.commit_advances.inc()
        self.commit_entries.inc(new - old)
        if self.tracer is not None:
            self.tracer.emit(
                "commit_advance",
                group=group,
                id=id,
                term=term,
                old=old,
                new=new,
            )

    def on_append_rejected(self, group: int, id: int, term: int, index: int) -> None:
        self.appends_rejected.inc()
        if self.tracer is not None:
            self.tracer.emit(
                "append_rejected", group=group, id=id, term=term, index=index
            )

    def on_snapshot_sent(self, group: int, id: int, to: int, index: int) -> None:
        self.snapshots_sent.inc()
        if self.tracer is not None:
            self.tracer.emit(
                "snapshot_send", group=group, id=id, to=to, index=index
            )

    def on_conf_change(self, group: int, id: int, term: int) -> None:
        self.conf_changes.inc()
        if self.tracer is not None:
            self.tracer.emit("conf_change", group=group, id=id, term=term)

    # --- RawNode hooks (raw_node.py) ---

    def on_ready(self, must_sync: bool) -> None:
        self.ready_cycles.inc()
        if must_sync:
            self.must_sync.inc()

    def on_advance(self) -> None:
        self.advance_cycles.inc()

    # --- MultiRaft driver hooks (multiraft/driver.py) ---

    def on_driver_tick(
        self,
        n_active: int,
        n_campaign: int,
        n_beat: int,
        n_checkq: int,
        sync_seconds: float,
    ) -> None:
        self.driver_ticks.inc()
        self.driver_active_groups.inc(n_active)
        self.driver_campaigns_fired.inc(n_campaign)
        self.driver_beats_fired.inc(n_beat)
        self.driver_checkq_fired.inc(n_checkq)
        self.driver_last_active.set(n_active)
        self.driver_sync_seconds.observe(sync_seconds)

    def on_ready_scan(self, scanned: int, skipped: int) -> None:
        self.ready_scan_scanned.inc(scanned)
        self.ready_scan_skipped.inc(skipped)

    # --- fleet-health hooks (multiraft/health.py HealthMonitor) ---

    def on_health_summary(self, summary: dict) -> None:
        """Publish one fixed-size health summary (the dict shape produced
        by ClusterSim.health() / MultiRaft.health()) as gauges."""
        from ..multiraft.kernels import LAG_BUCKET_BOUNDS

        self.health_summaries.inc()
        counts = summary.get("counts", {})
        self.health_leaderless.set(counts.get("leaderless", 0))
        self.health_stalled_leaderless.set(
            counts.get("stalled_leaderless", 0)
        )
        self.health_commit_stalled.set(counts.get("commit_stalled", 0))
        self.health_churning.set(counts.get("churning", 0))
        worst = summary.get("worst") or []
        if worst:
            self.health_worst_score.set(worst[0]["score"])
        bounds = (0,) + LAG_BUCKET_BOUNDS
        for lo, n in zip(bounds, summary.get("lag_hist", ())):
            self.health_commit_lag.labels(ge=lo).set(n)
