"""Quorum math: shared types (reference: src/quorum.rs).

This package is deliberately pure integer math with no dependencies on the
rest of the core — it is the scalar oracle for the batched TPU quorum kernels
in raft_tpu_torch.multiraft.kernels (which compute the same committed-index /
vote-result over [G, P] device arrays).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Protocol

U64_MAX = (1 << 64) - 1


class VoteResult(enum.IntEnum):
    """Outcome of a vote (reference: src/quorum.rs:12-20)."""

    Pending = 0
    Lost = 1
    Won = 2

    def __str__(self) -> str:
        return {
            VoteResult.Won: "VoteWon",
            VoteResult.Lost: "VoteLost",
            VoteResult.Pending: "VotePending",
        }[self]


@dataclass(frozen=True)
class Index:
    """A raft log position, optionally tagged with a commit group
    (reference: src/quorum.rs:35-38)."""

    index: int = 0
    group_id: int = 0


class AckedIndexer(Protocol):
    """Provider of per-voter acknowledged log indexes (reference: quorum.rs:63-65)."""

    def acked_index(self, voter_id: int) -> Optional[Index]: ...


class AckIndexer(Dict[int, Index]):
    """Map-backed AckedIndexer (reference: src/quorum.rs:67-74)."""

    def acked_index(self, voter_id: int) -> Optional[Index]:
        return self.get(voter_id)


from .joint import JointConfig  # noqa: E402
from .majority import MajorityConfig  # noqa: E402

__all__ = [
    "VoteResult",
    "Index",
    "AckedIndexer",
    "AckIndexer",
    "MajorityConfig",
    "JointConfig",
    "U64_MAX",
]
