"""Majority quorum math (reference: src/quorum/majority.rs).

`committed_index` is THE hot function of the whole framework: the batched TPU
backend re-implements it as a fixed-width masked sorting network over the peer
axis of `matched[G, P]` (see raft_tpu_torch.multiraft.kernels.committed_index); this
scalar version is the parity oracle.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Set, Tuple

from ..util import majority
from . import AckedIndexer, Index, U64_MAX, VoteResult


class MajorityConfig:
    """A set of voter IDs using majority quorums (reference: majority.rs:14-30)."""

    __slots__ = ("voters",)

    def __init__(self, voters: Iterable[int] = ()):  # noqa: D401
        self.voters: Set[int] = set(voters)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, MajorityConfig) and self.voters == other.voters

    def __contains__(self, id: int) -> bool:
        return id in self.voters

    def __len__(self) -> int:
        return len(self.voters)

    def __bool__(self) -> bool:
        # NB: truthiness is "non-empty", matching the use of is_empty() in the
        # reference; do not confuse with vote results.
        return bool(self.voters)

    def __repr__(self) -> str:
        return f"MajorityConfig({sorted(self.voters)})"

    def __str__(self) -> str:
        return "(" + " ".join(str(v) for v in sorted(self.voters)) + ")"

    def ids(self) -> Set[int]:
        return self.voters

    def slice(self) -> list:
        """Sorted voter list (reference: majority.rs:51-55)."""
        return sorted(self.voters)

    def is_empty(self) -> bool:
        return not self.voters

    def clear(self) -> None:
        self.voters.clear()

    def clone(self) -> "MajorityConfig":
        return MajorityConfig(self.voters)

    def committed_index(
        self, use_group_commit: bool, l: AckedIndexer
    ) -> Tuple[int, bool]:
        """The largest index committed by this majority config
        (reference: majority.rs:70-124).

        Gathers each voter's acked index (0 when absent), reverse-sorts, and
        takes the element at position `majority(n) - 1`.  An empty config
        returns (U64_MAX, True) so joint quorums behave like the other half.

        With group commit enabled, the commit additionally requires acks from
        at least two distinct commit groups (degrading to the minimum matched
        index when every acked voter shares one group); the bool in the result
        reports whether group commit was actually applied.
        """
        if not self.voters:
            return (U64_MAX, True)

        matched = [l.acked_index(v) or Index() for v in self.voters]
        matched.sort(key=lambda ix: ix.index, reverse=True)

        quorum_index = matched[majority(len(matched)) - 1]
        if not use_group_commit:
            return (quorum_index.index, False)

        quorum_commit_index = quorum_index.index
        checked_group_id = quorum_index.group_id
        single_group = True
        for m in matched:
            if m.group_id == 0:
                single_group = False
                continue
            if checked_group_id == 0:
                checked_group_id = m.group_id
                continue
            if checked_group_id == m.group_id:
                continue
            return (min(m.index, quorum_commit_index), True)
        if single_group:
            return (quorum_commit_index, False)
        return (matched[-1].index, False)

    def vote_result(self, check: Callable[[int], Optional[bool]]) -> VoteResult:
        """Tally yes/no/missing votes against the quorum
        (reference: majority.rs:130-154).  Empty configs win by convention.
        """
        if not self.voters:
            return VoteResult.Won

        yes = 0
        missing = 0
        for v in self.voters:
            vote = check(v)
            if vote is True:
                yes += 1
            elif vote is None:
                missing += 1
        q = majority(len(self.voters))
        if yes >= q:
            return VoteResult.Won
        if yes + missing >= q:
            return VoteResult.Pending
        return VoteResult.Lost

    def describe(self, l: AckedIndexer) -> str:
        """Multi-line rendering of per-voter commit indexes, for debugging and
        golden tests (reference: majority.rs:171-238)."""
        n = len(self.voters)
        if n == 0:
            return "<empty majority quorum>"

        info = []
        for id in self.voters:
            info.append({"id": id, "idx": l.acked_index(id), "bar": 0})

        info.sort(key=lambda t: ((t["idx"] or Index()).index, t["id"]))
        for i in range(1, n):
            if (info[i - 1]["idx"] or Index()).index < (info[i]["idx"] or Index()).index:
                info[i]["bar"] = i
        info.sort(key=lambda t: t["id"])

        def fmt_index(ix: Index) -> str:
            body = "∞" if ix.index == U64_MAX else str(ix.index)
            return f"[{ix.group_id}]{body}" if ix.group_id else body

        out = [" " * n + "    idx"]
        for t in info:
            if t["idx"] is not None:
                bar = t["bar"]
                out.append(
                    "x" * bar + ">" + " " * (n - bar)
                    + f" {fmt_index(t['idx']):>5}    (id={t['id']})"
                )
            else:
                out.append("?" + " " * n + f" {fmt_index(Index()):>5}    (id={t['id']})")
        return "\n".join(out) + "\n"
