"""Rebuild a tracker's configuration from a ConfState — used at boot and on
snapshot restore (reference: src/confchange/restore.rs)."""

from __future__ import annotations

from typing import List, Tuple, TYPE_CHECKING

from ..eraftpb import ConfChangeSingle, ConfChangeType, ConfState
from .changer import Changer

if TYPE_CHECKING:
    from ..tracker import ProgressTracker


def to_conf_change_single(
    cs: ConfState,
) -> Tuple[List[ConfChangeSingle], List[ConfChangeSingle]]:
    """Translate a ConfState into (outgoing-ops, incoming-ops): applying the
    outgoing ops to an empty config and then entering joint with the incoming
    ops reproduces the ConfState (reference: restore.rs:14-85)."""
    outgoing = [
        ConfChangeSingle(ConfChangeType.AddNode, id) for id in cs.voters_outgoing
    ]
    incoming: List[ConfChangeSingle] = []
    # Remove all outgoing voters first, then add incoming voters and learners
    # on top (restore.rs:56-83).
    for id in cs.voters_outgoing:
        incoming.append(ConfChangeSingle(ConfChangeType.RemoveNode, id))
    for id in cs.voters:
        incoming.append(ConfChangeSingle(ConfChangeType.AddNode, id))
    for id in cs.learners:
        incoming.append(ConfChangeSingle(ConfChangeType.AddLearnerNode, id))
    for id in cs.learners_next:
        incoming.append(ConfChangeSingle(ConfChangeType.AddLearnerNode, id))
    return outgoing, incoming


def restore(tracker: "ProgressTracker", next_idx: int, cs: ConfState) -> None:
    """Run the change sequence enacting `cs` on an empty tracker
    (reference: restore.rs:91-107)."""
    outgoing, incoming = to_conf_change_single(cs)
    if not outgoing:
        for cc in incoming:
            cfg, changes = Changer(tracker).simple([cc])
            tracker.apply_conf(cfg, changes, next_idx)
    else:
        for cc in outgoing:
            cfg, changes = Changer(tracker).simple([cc])
            tracker.apply_conf(cfg, changes, next_idx)
        cfg, changes = Changer(tracker).enter_joint(cs.auto_leave, incoming)
        tracker.apply_conf(cfg, changes, next_idx)
