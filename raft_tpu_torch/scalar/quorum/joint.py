"""Joint quorum: decisions require both majorities (reference: src/quorum/joint.rs)."""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Set, Tuple

from . import AckedIndexer, VoteResult
from .majority import MajorityConfig


class JointConfig:
    """Two (possibly overlapping) majority configs; an index/vote must win in
    both (reference: joint.rs:12-15)."""

    __slots__ = ("incoming", "outgoing")

    def __init__(self, voters: Iterable[int] = ()):  # incoming-only config
        self.incoming = MajorityConfig(voters)
        self.outgoing = MajorityConfig()

    @classmethod
    def from_majorities(
        cls, incoming: MajorityConfig, outgoing: MajorityConfig
    ) -> "JointConfig":
        cfg = cls()
        cfg.incoming = incoming
        cfg.outgoing = outgoing
        return cfg

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, JointConfig)
            and self.incoming == other.incoming
            and self.outgoing == other.outgoing
        )

    def __repr__(self) -> str:
        return f"JointConfig(incoming={self.incoming!r}, outgoing={self.outgoing!r})"

    def clone(self) -> "JointConfig":
        cfg = JointConfig()
        cfg.incoming = self.incoming.clone()
        cfg.outgoing = self.outgoing.clone()
        return cfg

    def committed_index(
        self, use_group_commit: bool, l: AckedIndexer
    ) -> Tuple[int, bool]:
        """Jointly committed index = min over both majorities
        (reference: joint.rs:47-51)."""
        i_idx, i_gc = self.incoming.committed_index(use_group_commit, l)
        o_idx, o_gc = self.outgoing.committed_index(use_group_commit, l)
        return (min(i_idx, o_idx), i_gc and o_gc)

    def vote_result(self, check: Callable[[int], Optional[bool]]) -> VoteResult:
        """Won iff won in both; lost if lost in either; else pending
        (reference: joint.rs:56-67)."""
        i = self.incoming.vote_result(check)
        o = self.outgoing.vote_result(check)
        if i == VoteResult.Won and o == VoteResult.Won:
            return VoteResult.Won
        if i == VoteResult.Lost or o == VoteResult.Lost:
            return VoteResult.Lost
        return VoteResult.Pending

    def clear(self) -> None:
        self.incoming.clear()
        self.outgoing.clear()

    def is_singleton(self) -> bool:
        """True iff exactly one voting member exists (reference: joint.rs:77-79)."""
        return self.outgoing.is_empty() and len(self.incoming) == 1

    def ids(self) -> Set[int]:
        """Union of both configs (reference: joint.rs:82-84)."""
        return self.incoming.ids() | self.outgoing.ids()

    def contains(self, id: int) -> bool:
        return id in self.incoming or id in self.outgoing

    def describe(self, l: AckedIndexer) -> str:
        return MajorityConfig(self.ids()).describe(l)
