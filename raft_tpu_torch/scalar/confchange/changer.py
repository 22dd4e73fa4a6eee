"""Validated membership-change transitions (reference: src/confchange/changer.rs).

Host-side by design: conf changes are rare, so the batched MultiRaft path
treats them as per-group barriers that re-materialize the device voter masks
(SURVEY.md §7 hard-part 5).
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Tuple, TYPE_CHECKING

from ..eraftpb import ConfChangeSingle, ConfChangeType
from ..errors import ConfChangeError

if TYPE_CHECKING:
    from ..tracker import Configuration, ProgressMap, ProgressTracker


class MapChangeType(enum.IntEnum):
    """Progress-map delta entry kind (reference: changer.rs:8-11)."""

    Add = 0
    Remove = 1


MapChange = List[Tuple[int, MapChangeType]]


def joint(conf: "Configuration") -> bool:
    """A config is joint iff the outgoing majority is non-empty
    (reference: src/confchange.rs `joint`)."""
    return not conf.voters.outgoing.is_empty()


class IncrChangeMap:
    """Stores progress-map updates instead of applying them directly
    (reference: changer.rs:17-34)."""

    __slots__ = ("changes", "base")

    def __init__(self, base: "ProgressMap"):
        self.changes: MapChange = []
        self.base = base

    def contains(self, id: int) -> bool:
        for i, ct in reversed(self.changes):
            if i == id:
                return ct == MapChangeType.Add
        return id in self.base


class Changer:
    """Validates and computes configuration transitions
    (reference: changer.rs:40-280)."""

    __slots__ = ("tracker",)

    def __init__(self, tracker: "ProgressTracker"):
        self.tracker = tracker

    def enter_joint(
        self, auto_leave: bool, ccs: Sequence[ConfChangeSingle]
    ) -> Tuple["Configuration", MapChange]:
        """Transition (1 2 3)&&() -> (1 2 3 + changes)&&(1 2 3), i.e. into
        C_{new,old} of the Raft thesis §4.3 (reference: changer.rs:66-89)."""
        if joint(self.tracker.conf):
            raise ConfChangeError("config is already joint")
        cfg, prs = self._check_and_copy()
        if cfg.voters.incoming.is_empty():
            raise ConfChangeError("can't make a zero-voter config joint")
        cfg.voters.outgoing.voters.update(cfg.voters.incoming.ids())
        self._apply(cfg, prs, ccs)
        cfg.auto_leave = auto_leave
        check_invariants(cfg, prs)
        return cfg, prs.changes

    def leave_joint(self) -> Tuple["Configuration", MapChange]:
        """Transition C_{new,old} -> C_new: drop the outgoing config and
        promote staged learners (reference: changer.rs:104-129)."""
        if not joint(self.tracker.conf):
            raise ConfChangeError("can't leave a non-joint config")
        cfg, prs = self._check_and_copy()
        if cfg.voters.outgoing.is_empty():
            raise ConfChangeError(f"configuration is not joint: {cfg}")
        cfg.learners.update(cfg.learners_next)
        cfg.learners_next.clear()

        for id in cfg.voters.outgoing.ids():
            if id not in cfg.voters.incoming and id not in cfg.learners:
                prs.changes.append((id, MapChangeType.Remove))

        cfg.voters.outgoing.clear()
        cfg.auto_leave = False
        check_invariants(cfg, prs)
        return cfg, prs.changes

    def simple(self, ccs: Sequence[ConfChangeSingle]) -> Tuple["Configuration", MapChange]:
        """Apply changes mutating the incoming voters by at most one
        (reference: changer.rs:135-157)."""
        if joint(self.tracker.conf):
            raise ConfChangeError("can't apply simple config change in joint config")
        cfg, prs = self._check_and_copy()
        self._apply(cfg, prs, ccs)

        sym_diff = cfg.voters.incoming.ids() ^ self.tracker.conf.voters.incoming.ids()
        if len(sym_diff) > 1:
            raise ConfChangeError(
                "more than one voter changed without entering joint config"
            )
        check_invariants(cfg, prs)
        return cfg, prs.changes

    # --- internals (reference: changer.rs:162-279) ---

    def _apply(
        self,
        cfg: "Configuration",
        prs: IncrChangeMap,
        ccs: Sequence[ConfChangeSingle],
    ) -> None:
        for cc in ccs:
            if cc.node_id == 0:
                # node_id zero means "change elided downstream"; skip.
                continue
            if cc.change_type == ConfChangeType.AddNode:
                self._make_voter(cfg, prs, cc.node_id)
            elif cc.change_type == ConfChangeType.AddLearnerNode:
                self._make_learner(cfg, prs, cc.node_id)
            else:
                self._remove(cfg, prs, cc.node_id)
        if cfg.voters.incoming.is_empty():
            raise ConfChangeError("removed all voters")

    def _make_voter(self, cfg: "Configuration", prs: IncrChangeMap, id: int) -> None:
        if not prs.contains(id):
            self._init_progress(cfg, prs, id, is_learner=False)
            return
        cfg.voters.incoming.voters.add(id)
        cfg.learners.discard(id)
        cfg.learners_next.discard(id)

    def _make_learner(self, cfg: "Configuration", prs: IncrChangeMap, id: int) -> None:
        if not prs.contains(id):
            self._init_progress(cfg, prs, id, is_learner=True)
            return
        if id in cfg.learners:
            return
        cfg.voters.incoming.voters.discard(id)
        cfg.learners.discard(id)
        cfg.learners_next.discard(id)
        # A voter still present in the outgoing config is only *staged* as a
        # learner (learners_next) to preserve voter/learner disjointness.
        if id in cfg.voters.outgoing:
            cfg.learners_next.add(id)
        else:
            cfg.learners.add(id)

    def _remove(self, cfg: "Configuration", prs: IncrChangeMap, id: int) -> None:
        if not prs.contains(id):
            return
        cfg.voters.incoming.voters.discard(id)
        cfg.learners.discard(id)
        cfg.learners_next.discard(id)
        # Keep the Progress while the peer is still an outgoing voter.
        if id not in cfg.voters.outgoing:
            prs.changes.append((id, MapChangeType.Remove))

    def _init_progress(
        self, cfg: "Configuration", prs: IncrChangeMap, id: int, is_learner: bool
    ) -> None:
        if not is_learner:
            cfg.voters.incoming.voters.add(id)
        else:
            cfg.learners.add(id)
        prs.changes.append((id, MapChangeType.Add))

    def _check_and_copy(self) -> Tuple["Configuration", IncrChangeMap]:
        prs = IncrChangeMap(self.tracker.progress)
        check_invariants(self.tracker.conf, prs)
        return self.tracker.conf.clone(), prs


def check_invariants(cfg: "Configuration", prs: IncrChangeMap) -> None:
    """Config/progress compatibility invariants (reference: changer.rs:285-355)."""
    for id in cfg.voters.ids():
        if not prs.contains(id):
            raise ConfChangeError(f"no progress for voter {id}")
    for id in cfg.learners:
        if not prs.contains(id):
            raise ConfChangeError(f"no progress for learner {id}")
        if id in cfg.voters.outgoing:
            raise ConfChangeError(f"{id} is in learners and outgoing voters")
        if id in cfg.voters.incoming:
            raise ConfChangeError(f"{id} is in learners and incoming voters")
    for id in cfg.learners_next:
        if not prs.contains(id):
            raise ConfChangeError(f"no progress for learner(next) {id}")
        if id not in cfg.voters.outgoing:
            raise ConfChangeError(f"{id} is in learners_next and outgoing voters")
    if not joint(cfg):
        if cfg.learners_next:
            raise ConfChangeError("learners_next must be empty when not joint")
        if cfg.auto_leave:
            raise ConfChangeError("auto_leave must be false when not joint")
