"""The part of the error hierarchy the membership code raises (reference:
`raft_tpu/errors.py`, after raft-rs's src/errors.rs).  Equality compares type
and message, as the reference's tests rely on."""

from __future__ import annotations


class RaftError(Exception):
    """Base class of the scalar core's errors (reference: src/errors.rs:6)."""

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self.args == other.args  # type: ignore[union-attr]

    def __hash__(self) -> int:
        return hash((type(self), self.args))


class ConfChangeError(RaftError):
    """Invalid membership-change request (reference: errors.rs ConfChangeError)."""
