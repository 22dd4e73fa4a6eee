"""ReadOnlyOption enum, split into its own module to avoid a config <-> read_only
import cycle (reference: src/read_only.rs:26-36)."""

from __future__ import annotations

import enum


class ReadOnlyOption(enum.IntEnum):
    """How linearizable reads are served (reference: read_only.rs:26-36)."""

    # Safe: guarantee linearizability by confirming leadership with a quorum
    # round-trip (ReadIndex ctx piggybacked on heartbeats).
    Safe = 0
    # LeaseBased: rely on the leader lease (requires check_quorum); cheaper but
    # affected by clock drift.
    LeaseBased = 1
