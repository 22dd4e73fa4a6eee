"""Raft node configuration (reference: src/config.rs:26-210).

A plain dataclass with the same 15 tunables and the same `validate()` rules as
the reference.  The batched MultiRaft path re-uses this per-group config but
also accepts per-group *arrays* of tick bounds (see raft_tpu_torch.multiraft).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .errors import ConfigInvalid
from .read_only_option import ReadOnlyOption
from .util import NO_LIMIT

INVALID_ID = 0
INVALID_INDEX = 0


@dataclass
class HealthConfig:
    """Fleet-health telemetry thresholds (raft-tpu extension; no reference
    analog — the reference observes one group, this observes 100k).

    Shared by the host HealthMonitor (raft_tpu_torch/multiraft/health.py), the
    MultiRaft driver's numpy health planes, and — mirrored into the
    SimConfig fields of the same names — the device-resident planes
    (raft_tpu_torch/multiraft/sim.py).  All values are in ticks/rounds except
    `churn_bumps` (term bumps per window) and the two sizes.
    """

    # Churn window length: term_bumps_in_window covers at most this many
    # trailing rounds.
    window: int = 32
    # A group is "stalled leaderless" at/over this many leaderless ticks.
    leaderless_stall_ticks: int = 16
    # A group is "commit stalled" at/over this many flat-commit ticks.
    commit_stall_ticks: int = 32
    # A group is "churning" at/over this many term bumps per window.
    churn_bumps: int = 4
    # Worst-offender extraction width (top-k).
    topk: int = 8
    # Flight-recorder ring capacity (summaries kept for post-mortems).
    recorder_size: int = 64

    def validate(self) -> None:
        if self.window <= 0:
            raise ConfigInvalid("health window must be greater than 0")
        if self.topk <= 0:
            raise ConfigInvalid("health topk must be greater than 0")
        if self.recorder_size <= 0:
            raise ConfigInvalid("health recorder size must be greater than 0")
        if min(
            self.leaderless_stall_ticks,
            self.commit_stall_ticks,
            self.churn_bumps,
        ) <= 0:
            raise ConfigInvalid("health thresholds must be greater than 0")

# Default ceiling on committed entries delivered per Ready
# (reference: config.rs:103-125 uses MAX_COMMITTED_SIZE_PER_READY).
MAX_COMMITTED_SIZE_PER_READY = NO_LIMIT


@dataclass
class Config:
    """Configuration for a raft node (reference: src/config.rs:26-101)."""

    # The identity of the local raft node. Cannot be 0.
    id: int = 0
    # Ticks between elections: a follower campaigns if it receives no message
    # from the leader for `election_tick` ticks.  Should be 10x heartbeat_tick.
    election_tick: int = 0
    # Ticks between heartbeats sent by a leader.
    heartbeat_tick: int = 0
    # The last applied index on restart; entries <= applied are not re-delivered.
    applied: int = 0
    # Byte cap on each outgoing append message (prevents infinite sync lag).
    max_size_per_msg: int = 0
    # In-flight append message window per peer (flow control).
    max_inflight_msgs: int = 256
    # Leader self-demotes when it cannot reach a quorum within election_tick.
    check_quorum: bool = False
    # Enable Pre-Vote (Raft thesis 9.6) to avoid term explosion after partition.
    pre_vote: bool = False
    # Linearizable-read mode (Safe quorum-checked / LeaseBased).
    read_only_option: ReadOnlyOption = ReadOnlyOption.Safe
    # Randomized election timeout bounds; 0 means derive from election_tick
    # as [election_tick, 2 * election_tick) (reference: config.rs:76-88).
    min_election_tick: int = 0
    max_election_tick: int = 0
    # Don't broadcast a commit-index update on every commit (batch it).
    skip_bcast_commit: bool = False
    # Batch consecutive appends into one MsgAppend where possible.
    batch_append: bool = False
    # Election priority of this node (reference: config.rs priority).
    priority: int = 0
    # Byte cap on uncommitted proposals buffered at the leader (0 = no limit).
    max_uncommitted_size: int = NO_LIMIT
    # Byte cap on committed entries delivered per Ready (pagination).
    max_committed_size_per_ready: int = MAX_COMMITTED_SIZE_PER_READY
    # raft-tpu extension: seed mixed into the deterministic election-timeout
    # PRNG key (node_key = timeout_seed * 2**16 + id).  Lets many groups that
    # share peer ids 1..P (the MultiRaft batch) draw independent timeout
    # streams while staying bit-identical to the device kernel.
    timeout_seed: int = 0
    # raft-tpu extension: an optional observability hook, any object with the
    # reference Metrics' on_* methods (this package has no Metrics class yet).
    # None (the default) disables all instrumentation; every hook in the hot
    # path is guarded by a single `is not None` branch.  A deployment shares
    # ONE instance across its nodes/groups — counters aggregate, trace
    # events stay tagged per (group, id).
    metrics: Optional[object] = None

    def min_election_tick_or_default(self) -> int:
        """reference: config.rs:129-136"""
        return self.min_election_tick if self.min_election_tick != 0 else self.election_tick

    def max_election_tick_or_default(self) -> int:
        """reference: config.rs:139-146"""
        return (
            self.max_election_tick
            if self.max_election_tick != 0
            else 2 * self.election_tick
        )

    def validate(self) -> None:
        """Validate config invariants (reference: src/config.rs:157-209)."""
        if self.id == INVALID_ID:
            raise ConfigInvalid("invalid node id")
        if self.heartbeat_tick == 0:
            raise ConfigInvalid("heartbeat tick must be greater than 0")
        if self.election_tick <= self.heartbeat_tick:
            raise ConfigInvalid("election tick must be greater than heartbeat tick")
        min_timeout = self.min_election_tick_or_default()
        max_timeout = self.max_election_tick_or_default()
        if min_timeout < self.election_tick:
            raise ConfigInvalid(
                f"min election tick {min_timeout} must not be less than election_tick {self.election_tick}"
            )
        if min_timeout >= max_timeout:
            raise ConfigInvalid(
                f"min election tick {min_timeout} should be less than max election tick {max_timeout}"
            )
        if self.max_inflight_msgs == 0:
            raise ConfigInvalid("max inflight messages must be greater than 0")
        if self.read_only_option == ReadOnlyOption.LeaseBased and not self.check_quorum:
            raise ConfigInvalid(
                "read_only_option == LeaseBased requires check_quorum == true"
            )
        if self.max_uncommitted_size < self.max_size_per_msg:
            raise ConfigInvalid(
                "max uncommitted size should be greater than max_size_per_msg"
            )


def new_config_for_test(id: int = 1, election_tick: int = 10, heartbeat_tick: int = 1) -> Config:
    """Convenience constructor mirroring harness test defaults."""
    return Config(id=id, election_tick=election_tick, heartbeat_tick=heartbeat_tick)
