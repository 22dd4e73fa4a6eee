"""The membership part of the wire format (reference: `raft_tpu/eraftpb.py`,
after raft-rs's proto/proto/eraftpb.proto): `ConfChangeType`,
`ConfChangeSingle`, `ConfState` and `conf_state_eq`, as plain dataclasses.
Zero-valued fields mean "absent", as in proto3."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List


class ConfChangeType(enum.IntEnum):
    """reference: proto/proto/eraftpb.proto:133-137"""

    AddNode = 0
    RemoveNode = 1
    AddLearnerNode = 2


@dataclass(slots=True)
class ConfState:
    """Membership configuration (reference: proto/proto/eraftpb.proto:118-131)."""

    voters: List[int] = field(default_factory=list)
    learners: List[int] = field(default_factory=list)
    voters_outgoing: List[int] = field(default_factory=list)
    learners_next: List[int] = field(default_factory=list)
    auto_leave: bool = False

    def clone(self) -> "ConfState":
        return ConfState(
            voters=list(self.voters),
            learners=list(self.learners),
            voters_outgoing=list(self.voters_outgoing),
            learners_next=list(self.learners_next),
            auto_leave=self.auto_leave,
        )


def conf_state_eq(lhs: ConfState, rhs: ConfState) -> bool:
    """Order-insensitive ConfState equality (reference: proto/src/confstate.rs:21-40)."""
    return (
        sorted(lhs.voters) == sorted(rhs.voters)
        and sorted(lhs.learners) == sorted(rhs.learners)
        and sorted(lhs.voters_outgoing) == sorted(rhs.voters_outgoing)
        and sorted(lhs.learners_next) == sorted(rhs.learners_next)
        and lhs.auto_leave == rhs.auto_leave
    )


@dataclass(slots=True)
class ConfChangeSingle:
    """reference: proto/proto/eraftpb.proto:149-152"""

    change_type: ConfChangeType = ConfChangeType.AddNode
    node_id: int = 0
