"""Shared helpers of the scalar core (reference: `raft_tpu/util.py`, after
raft-rs's src/util.rs); only what the quorum math needs."""

from __future__ import annotations


def majority(total: int) -> int:
    """Quorum size for a set of `total` voters (reference: util.rs:118-120)."""
    return total // 2 + 1
