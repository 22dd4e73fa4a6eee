"""Per-peer replication FSM states (reference: src/tracker/state.rs:22-45).

IntEnum so the batched MultiRaft path can mirror the state as a uint8 plane
`pr_state[G, P]` on device.
"""

from __future__ import annotations

import enum


class ProgressState(enum.IntEnum):
    """Replication state of a peer as seen by the leader."""

    # Leader sends at most one replication message per heartbeat interval and
    # probes the follower's actual progress.
    Probe = 0
    # Leader optimistically pipelines replication messages.
    Replicate = 1
    # Leader has sent a snapshot and pauses replication until it's reported.
    Snapshot = 2
