"""Membership churn: declarative joint-consensus reconfig plans compiled into
per-group schedules on the device, and the runners that drive a whole plan
through the batched step.

Counterpart of `raft_tpu/multiraft/reconfig.py` (all of it).  Its two
runners, :func:`make_runner` and :func:`make_split_runner`, are wrappers
over `runner.make_runner`, which builds them in `runner._make_reconfig`
and `_make_reconfig_split` as the reference's runner.py does (:208-491);
the split runner refuses a black-box config as the reference's does.

A :class:`ReconfigPlan` is a list of phases; a phase may carry ONE
conf-change op (add/remove voter, add/promote learner, explicit
joint-entry/joint-exit) that is enqueued for the selected groups at the
phase's first round.  :func:`compile_plan` lowers the plan on the host by
driving the scalar ``confchange.Changer`` (the port's own copy in
`raft_tpu_torch/scalar/`): every transition is validated and its target
masks computed by the reference's own rules (one voter per simple step,
outgoing := old incoming on joint entry, ``learners_next`` staged and
materialized on leave) into dense per-op schedule arrays.

The op protocol per group, one round at a time (`_runner_body`):

  propose   an eligible op (its phase reached, all earlier ops applied)
            appends one conf entry at the group's acting leader, and the
            step reports where it landed (sim.ReconfigProposal); no alive
            leader -> retry next round;
  wait      the swap is gated on the entry committing under both
            majorities of the (possibly joint) config: the owner still
            leads at its propose term, is not crashed, and its commit
            covers the entry;
  retry     a deposed or crashed owner invalidates the pending entry, and
            the op re-proposes at the next acting leader;
  apply     ``kernels.apply_confchange`` swaps the mask planes and runs
            the apply-time reactions (leader step-down, fresh tracker rows,
            quorum-shrink commit pickup).

Every round also folds ``kernels.check_safety`` with the joint-window
invariants (the mask transition pair is checked one round later, with a
tail check after the last round), the chaos MTTR stats and the reconfig
stats (proposals, applies, retries, joint group-rounds).

Where the reference traces one jitted ``lax.scan``, :func:`make_runner` is
a host loop over the rounds that adds no host sync of its own (the phase
lookup reads `phase_of_round`, which stays on the CPU).
:func:`make_split_runner` splits the horizon at the op windows
(:func:`split_plan`): the general segments run the same per-round body,
and each planned fused k-round block checks ``fused_step.steady_mask``
with ``reconfig_pending=pending_in_horizon(...)`` over the whole batch
(one host ``bool()`` a block, where the reference's ``lax.cond`` picks)
and runs the fused kernel through ``fused_step.steady_round`` /
``chaos_round`` (the damped kernel for a damped config) with the health
planes, or k general rounds.

Plan JSON (tests/testdata/reconfig/plans.json, examples/reconfig/)::

    {"name": "joint-churn", "peers": 5, "voters": [1, 2, 3],
     "learners": [4],
     "phases": [
        {"rounds": 30},                                     # settle
        {"rounds": 40, "op": {"enter_joint": [{"add": 5}, {"remove": 1}]},
         "groups": {"mod": 2, "eq": 0}, "append": 1},
        {"rounds": 20, "op": {"leave_joint": true}},
        {"rounds": 10, "op": {"promote_learner": 4}}]}

Op forms: ``{"add_voter": p}``, ``{"remove_voter": p}``,
``{"add_learner": p}``, ``{"promote_learner": p}`` (single-step simple
changes), ``{"enter_joint": [{"add": p} | {"remove": p} | {"learner": p},
...]}`` and ``{"leave_joint": true}``.  Ops queue strictly in phase order
per group.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import chaos as chaos_mod
from . import kernels
from . import sim as sim_mod
from .kernels import HP_LEADERLESS, N_SAFETY
from .platform import DeviceLike, resolve_device
from ..scalar.confchange import Changer
from ..scalar.eraftpb import ConfChangeSingle, ConfChangeType
from ..scalar.tracker import ProgressTracker

I32 = torch.int32

# Padding sentinel for op_start: far beyond any legal plan (compile_plan
# bounds rounds x groups < 2**31, so rounds < 2**30 whenever G >= 2).
NO_ROUND = 1 << 30

_SIMPLE_OPS = ("add_voter", "remove_voter", "add_learner", "promote_learner")


@dataclass
class ReconfigPhase:
    """One contiguous stretch of rounds, optionally enqueuing ONE op.

    rounds: phase length in protocol rounds (>= 1).
    op:     the op document ({"add_voter": p}, {"enter_joint": [...]},
            {"leave_joint": true}, ...) enqueued for the selected groups
            at the phase's first round; None = settle/wait phase.
    groups: which groups the op applies to (chaos.py group selectors).
    append: per-round append workload proposed at each group's leader
            for the phase (all groups).
    """

    rounds: int
    op: Optional[Dict[str, object]] = None
    groups: chaos_mod.GroupSel = "all"
    append: int = 0


@dataclass
class ReconfigPlan:
    """A named multi-phase membership-churn scenario (host-side).
    `voters`/`learners` (1-based peer ids) are the bootstrap configuration
    of every group: the state the runner is applied to must start in it
    (use :func:`initial_masks`)."""

    name: str
    n_peers: int
    phases: List[ReconfigPhase]
    voters: List[int] = field(default_factory=list)
    learners: List[int] = field(default_factory=list)

    @property
    def n_rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)


def plan_from_dict(doc: Dict[str, object]) -> ReconfigPlan:
    """Build a ReconfigPlan from its JSON document form (module doc)."""
    n_peers = int(doc["peers"])  # type: ignore[arg-type]
    phases: List[ReconfigPhase] = []
    for ph in doc["phases"]:  # type: ignore[index]
        if not isinstance(ph, dict):
            raise ValueError(f"phase is not an object: {ph!r}")
        phases.append(
            ReconfigPhase(
                rounds=int(ph["rounds"]),
                op=ph.get("op"),
                groups=ph.get("groups", "all"),
                append=int(ph.get("append", 0)),
            )
        )
    voters = [int(p) for p in doc.get("voters", [])]  # type: ignore[union-attr]
    return ReconfigPlan(
        name=str(doc.get("name", "unnamed")),
        n_peers=n_peers,
        phases=phases,
        voters=voters or list(range(1, n_peers + 1)),
        learners=[int(p) for p in doc.get("learners", [])],  # type: ignore[union-attr]
    )


def load_plan(path: str) -> ReconfigPlan:
    """Load a ReconfigPlan from a JSON file (the bench.py --reconfig input)."""
    with open(path, "r", encoding="utf-8") as f:
        return plan_from_dict(json.load(f))


# --- host-side compilation: drive the scalar confchange path ---------------


class _OpSlot(NamedTuple):
    """One validated transition of one group chain: the Changer-computed
    target configuration (as plain sets), the progress-map delta, and the
    member delta the device kernel applies."""

    voters_inc: frozenset
    voters_out: frozenset
    learners: frozenset
    learners_next: frozenset
    changes: Tuple[Tuple[int, int], ...]  # (peer id, MapChangeType value)
    added: frozenset  # fresh members (fresh tracker rows + ra grace)
    removed: frozenset  # ex-members (tracker rows cleared)
    phase: int  # the enqueuing phase index (start-round lookup)


def _peer(pid: object, n_peers: int, what: str, phase: int) -> int:
    p = int(pid)  # type: ignore[call-overload]
    if not 1 <= p <= n_peers:
        raise ValueError(
            f"phase {phase}: {what} peer id {p} out of range [1, {n_peers}]"
        )
    return p


def _op_ccs(
    op: Dict[str, object], n_peers: int, phase: int
) -> Tuple[str, List[ConfChangeSingle]]:
    """Normalize one op document -> (kind, ConfChangeSingle list)."""
    kinds = [k for k in op if k in _SIMPLE_OPS + ("enter_joint", "leave_joint")]
    if len(kinds) != 1 or len(op) != 1:
        raise ValueError(
            f"phase {phase}: op must have exactly one kind, got {op!r}"
        )
    kind = kinds[0]
    V, L, R = (
        ConfChangeType.AddNode,
        ConfChangeType.AddLearnerNode,
        ConfChangeType.RemoveNode,
    )
    if kind == "leave_joint":
        # {"leave_joint": false} must fail loudly rather than still leave:
        # delete the op to make a phase a settle phase.
        if not op[kind]:
            raise ValueError(
                f"phase {phase}: leave_joint must be true — remove the "
                "op to disable the phase"
            )
        return kind, []
    if kind == "enter_joint":
        ccs = []
        for ch in op[kind]:  # type: ignore[attr-defined]
            if not isinstance(ch, dict) or len(ch) != 1:
                raise ValueError(
                    f"phase {phase}: enter_joint change must be one of "
                    f'{{"add"|"remove"|"learner": peer}}, got {ch!r}'
                )
            (what, pid), = ch.items()
            p = _peer(pid, n_peers, f"enter_joint {what}", phase)
            t = {"add": V, "remove": R, "learner": L}.get(what)
            if t is None:
                raise ValueError(
                    f"phase {phase}: unknown enter_joint change {what!r}"
                )
            ccs.append(ConfChangeSingle(t, p))
        if not ccs:
            raise ValueError(f"phase {phase}: enter_joint with no changes")
        return kind, ccs
    p = _peer(op[kind], n_peers, kind, phase)
    t = {"add_voter": V, "promote_learner": V, "add_learner": L,
         "remove_voter": R}[kind]
    return kind, [ConfChangeSingle(t, p)]


def _bootstrap_tracker(plan: ReconfigPlan) -> ProgressTracker:
    t = ProgressTracker(1 << 20)
    for v in plan.voters:
        _peer(v, plan.n_peers, "initial voter", -1)
        cfg, changes = Changer(t).simple(
            [ConfChangeSingle(ConfChangeType.AddNode, int(v))]
        )
        t.apply_conf(cfg, changes, 1)
    for l in plan.learners:
        _peer(l, plan.n_peers, "initial learner", -1)
        cfg, changes = Changer(t).simple(
            [ConfChangeSingle(ConfChangeType.AddLearnerNode, int(l))]
        )
        t.apply_conf(cfg, changes, 1)
    return t


def _member(t: ProgressTracker) -> frozenset:
    c = t.conf
    return frozenset(
        c.voters.incoming.ids() | c.voters.outgoing.ids() | c.learners
    )


def _walk_chain(
    plan: ReconfigPlan, sig: Tuple[int, ...]
) -> List[_OpSlot]:
    """Apply the op sequence `sig` (phase indices) through the scalar
    Changer, recording each validated transition."""
    t = _bootstrap_tracker(plan)
    slots: List[_OpSlot] = []
    for phase_idx in sig:
        op = plan.phases[phase_idx].op
        assert op is not None
        kind, ccs = _op_ccs(op, plan.n_peers, phase_idx)
        # Plan-typo guards beyond the Changer's own invariants: a no-op
        # simple change would propose and commit an entry that changes
        # nothing, almost certainly a plan mistake.
        inc = t.conf.voters.incoming.ids()
        if kind == "add_voter" and ccs[0].node_id in inc:
            raise ValueError(
                f"phase {phase_idx}: add_voter {ccs[0].node_id} is "
                "already a voter"
            )
        if kind == "promote_learner" and ccs[0].node_id not in t.conf.learners:
            raise ValueError(
                f"phase {phase_idx}: promote_learner {ccs[0].node_id} is "
                "not currently a learner"
            )
        if kind == "remove_voter" and ccs[0].node_id not in inc:
            raise ValueError(
                f"phase {phase_idx}: remove_voter {ccs[0].node_id} is "
                "not currently a voter"
            )
        if kind == "add_learner" and ccs[0].node_id in t.conf.learners:
            raise ValueError(
                f"phase {phase_idx}: add_learner {ccs[0].node_id} is "
                "already a learner"
            )
        old_member = _member(t)
        ch = Changer(t)
        if kind == "enter_joint":
            cfg, changes = ch.enter_joint(False, ccs)
        elif kind == "leave_joint":
            cfg, changes = ch.leave_joint()
        else:
            cfg, changes = ch.simple(ccs)
        t.apply_conf(cfg, changes, 1)
        new_member = _member(t)
        slots.append(
            _OpSlot(
                voters_inc=frozenset(cfg.voters.incoming.ids()),
                voters_out=frozenset(cfg.voters.outgoing.ids()),
                learners=frozenset(cfg.learners),
                learners_next=frozenset(cfg.learners_next),
                changes=tuple((int(i), int(ct)) for i, ct in changes),
                added=new_member - old_member,
                removed=old_member - new_member,
                phase=phase_idx,
            )
        )
    return slots


def _compile_schedule(plan: ReconfigPlan, n_groups: int):
    """The shared numpy schedule (the device schedule and the host twin):
    phase timing, per-group op chains (Changer-validated), and the dense
    per-slot target masks."""
    P, G = plan.n_peers, n_groups
    nph = len(plan.phases)
    if nph == 0:
        raise ValueError("plan has no phases")
    if plan.n_rounds * max(1, G) >= 2**31:
        raise ValueError(
            f"plan spans {plan.n_rounds} rounds x {G} groups >= 2**31 "
            "(group, round) pairs; the int32 reconfig/safety accumulators "
            "could wrap — split the plan"
        )
    phase_of_round = np.zeros(plan.n_rounds, dtype=np.int32)
    phase_start = np.zeros(nph, dtype=np.int32)
    append = np.zeros((nph, G), dtype=np.int32)
    r0 = 0
    op_phases: List[int] = []
    gsel_by_phase: Dict[int, np.ndarray] = {}
    for i, ph in enumerate(plan.phases):
        if ph.rounds < 1:
            raise ValueError(f"phase {i}: rounds must be >= 1")
        phase_of_round[r0 : r0 + ph.rounds] = i
        phase_start[i] = r0
        r0 += ph.rounds
        append[i] = ph.append
        if ph.op is not None:
            op_phases.append(i)
            gsel_by_phase[i] = chaos_mod._group_mask(ph.groups, G)
    if not op_phases:
        raise ValueError("plan has no reconfig ops (use a ChaosPlan for "
                         "pure fault scenarios)")
    # Per-group op signature -> Changer chain (validated once per distinct
    # sequence, shared across the groups that follow it).
    sig_of_group: List[Tuple[int, ...]] = []
    for g in range(G):
        sig_of_group.append(
            tuple(i for i in op_phases if gsel_by_phase[i][g])
        )
    chains: Dict[Tuple[int, ...], List[_OpSlot]] = {}
    for sig in set(sig_of_group):
        chains[sig] = _walk_chain(plan, sig)
    K = max(1, max(len(s) for s in sig_of_group))
    op_start = np.full((K, G), NO_ROUND, dtype=np.int32)
    n_ops = np.zeros(G, dtype=np.int32)
    tgt_voter = np.zeros((K, P, G), dtype=bool)
    tgt_outgoing = np.zeros((K, P, G), dtype=bool)
    tgt_learner = np.zeros((K, P, G), dtype=bool)
    added = np.zeros((K, P, G), dtype=bool)
    removed = np.zeros((K, P, G), dtype=bool)
    # Fill by distinct chain: every group of one signature gets the same
    # columns (the reference's per-group loop, vectorized over groups).
    for sig, slots in chains.items():
        cols = np.flatnonzero([s == sig for s in sig_of_group])
        n_ops[cols] = len(sig)
        for k, slot in enumerate(slots):
            op_start[k, cols] = phase_start[slot.phase]
            for p in range(P):
                pid = p + 1
                tgt_voter[k, p, cols] = pid in slot.voters_inc
                tgt_outgoing[k, p, cols] = pid in slot.voters_out
                # learners_next stay outgoing voters until leave-joint
                # materializes them (tracker.rs:50-83): the device learner
                # plane carries only the active learners.
                tgt_learner[k, p, cols] = pid in slot.learners
                added[k, p, cols] = pid in slot.added
                removed[k, p, cols] = pid in slot.removed
    return (
        phase_of_round, append, op_start, n_ops,
        tgt_voter, tgt_outgoing, tgt_learner, added, removed,
        sig_of_group, chains,
    )


class CompiledReconfig(NamedTuple):
    """Schedule arrays for one plan at one batch shape.  `phase_of_round`
    stays on the CPU (the round loop is a host loop, and looking a phase up
    there costs no device sync); the rest lie on the device.

    phase_of_round: int32[R] (CPU)  round -> phase index
    append:         int32[NPH, G]  per-phase append workload
    op_start:       int32[K, G]    round at which op k becomes eligible
                                   (NO_ROUND padding past n_ops)
    n_ops:          int32[G]       ops in the group's chain
    tgt_voter:      bool[K, P, G]  post-apply incoming-voter mask
    tgt_outgoing:   bool[K, P, G]  post-apply outgoing mask
    tgt_learner:    bool[K, P, G]  post-apply learner mask
    added:          bool[K, P, G]  fresh members (tracker-row reset + ra)
    removed:        bool[K, P, G]  ex-members (tracker rows cleared)
    n_peers:        the peer count
    """

    phase_of_round: torch.Tensor
    append: torch.Tensor
    op_start: torch.Tensor
    n_ops: torch.Tensor
    tgt_voter: torch.Tensor
    tgt_outgoing: torch.Tensor
    tgt_learner: torch.Tensor
    added: torch.Tensor
    removed: torch.Tensor
    n_peers: int

    @property
    def n_rounds(self) -> int:
        return int(self.phase_of_round.shape[0])


def compile_plan(
    plan: ReconfigPlan, n_groups: int, device: DeviceLike = None
) -> CompiledReconfig:
    """Lower a ReconfigPlan to schedule arrays for `n_groups` groups on
    `cuda` unless `device` says otherwise; every transition is
    Changer-validated on the host."""
    dev = resolve_device(device)
    (
        phase_of_round, append, op_start, n_ops,
        tgt_voter, tgt_outgoing, tgt_learner, added, removed,
        _, _,
    ) = _compile_schedule(plan, n_groups)

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    return CompiledReconfig(
        phase_of_round=torch.from_numpy(phase_of_round),
        append=on_dev(append),
        op_start=on_dev(op_start),
        n_ops=on_dev(n_ops),
        tgt_voter=on_dev(tgt_voter),
        tgt_outgoing=on_dev(tgt_outgoing),
        tgt_learner=on_dev(tgt_learner),
        added=on_dev(added),
        removed=on_dev(removed),
        n_peers=plan.n_peers,
    )


def initial_masks(
    plan: ReconfigPlan, n_groups: int, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(voter_mask, outgoing_mask, learner_mask) bool[P, G] of the plan's
    bootstrap configuration, on `cuda` unless `device` says otherwise: hand
    them to sim.init_state or ClusterSim so the state starts in the config
    the compiled chains transition from."""
    dev = resolve_device(device)
    P, G = plan.n_peers, n_groups
    vm = np.zeros((P, G), dtype=bool)
    lm = np.zeros((P, G), dtype=bool)
    for v in plan.voters:
        vm[_peer(v, P, "initial voter", -1) - 1] = True
    for l in plan.learners:
        lm[_peer(l, P, "initial learner", -1) - 1] = True
    return (
        torch.from_numpy(vm).to(dev),
        torch.zeros((P, G), dtype=torch.bool, device=dev),
        torch.from_numpy(lm).to(dev),
    )


class HostReconfigSchedule:
    """The compiled reconfig schedule kept in numpy: the same timing and
    eligibility arrays the device gathers (phase_of_round, append,
    op_start, n_ops, the target masks) plus, per (group, op slot), the
    Changer-computed transition record; both derive from one
    _compile_schedule walk."""

    def __init__(self, plan: ReconfigPlan, n_groups: int):
        (
            self.phase_of_round, self.append, self.op_start, self.n_ops,
            self.tgt_voter, self.tgt_outgoing, self.tgt_learner,
            self.added, self.removed,
            self._sig_of_group, self._chains,
        ) = _compile_schedule(plan, n_groups)
        self.n_rounds = plan.n_rounds
        self.n_peers = plan.n_peers
        self.n_groups = n_groups
        self.voters = list(plan.voters)
        self.learners = list(plan.learners)

    def slot(self, group: int, op_idx: int) -> _OpSlot:
        """The validated transition record for the group's op `op_idx`."""
        return self._chains[self._sig_of_group[group]][op_idx]


class ReconfigState(NamedTuple):
    """The runners' per-group op-protocol carry.

    stage:         0 = next op (if any) needs proposing, 1 = a conf entry
                   is in flight awaiting its dual-majority commit.
    op_ptr:        index of the next unapplied op in the group's chain.
    prop_owner:    proposing leader's peer id (1-based; 0 = none).
    prop_index:    the in-flight conf entry's log index.
    prop_term:     the proposing leader's term (the entry's term).
    prev_voter/prev_outgoing: the mask planes that governed the previous
                   round's step; the double-change safety check compares
                   each round's step masks against them, so every apply
                   is audited once, one round later (the tail check after
                   the last round covers a final-round apply).
    """

    stage: torch.Tensor  # int32[G]
    op_ptr: torch.Tensor  # int32[G]
    prop_owner: torch.Tensor  # int32[G]
    prop_index: torch.Tensor  # int32[G]
    prop_term: torch.Tensor  # int32[G]
    prev_voter: torch.Tensor  # bool[P, G]
    prev_outgoing: torch.Tensor  # bool[P, G]


def init_reconfig_state(st: sim_mod.SimState) -> ReconfigState:
    """Fresh op-protocol state for a run starting from `st`, on its
    device."""
    G = st.term.shape[1]
    dev = st.term.device

    def zeros():
        return torch.zeros((G,), dtype=I32, device=dev)

    return ReconfigState(
        stage=zeros(),
        op_ptr=zeros(),
        prop_owner=zeros(),
        prop_index=zeros(),
        prop_term=zeros(),
        prev_voter=st.voter_mask.clone(),
        prev_outgoing=st.outgoing_mask.clone(),
    )


# Reconfig stats accumulator indices ([N_RECONFIG_STATS] int32; each slot
# grows by at most G a round, and compile_plan bounds rounds x G < 2**31).
RC_PROPOSED = 0  # conf entries appended (retries re-count)
RC_APPLIED = 1  # mask swaps committed
RC_RETRIES = 2  # pending entries invalidated by owner deposition/crash
RC_JOINT_ROUNDS = 3  # (group, round) pairs spent inside a joint config
N_RECONFIG_STATS = 4

RECONFIG_STAT_NAMES = (
    "proposals",
    "ops_applied",
    "retries",
    "joint_group_rounds",
)


def _gather_peer(plane: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """plane[P, G], owner int32[G] (1-based, 0-safe) -> plane[owner-1, g]."""
    o = torch.clamp(owner - 1, 0, plane.shape[0] - 1).to(torch.int64)
    return plane.gather(0, o[None, :])[0]


def _gather_op(plane: torch.Tensor, op_ptr: torch.Tensor) -> torch.Tensor:
    """plane[K, ..., G], op_ptr int32[G] -> plane[op_ptr[g], ..., g]."""
    k = torch.clamp(op_ptr, 0, plane.shape[0] - 1).to(torch.int64)
    if plane.dim() == 2:
        return plane.gather(0, k[None, :])[0]
    idx = k[None, None, :].expand(1, plane.shape[1], plane.shape[2])
    return plane.gather(0, idx)[0]


def pending_in_horizon(
    compiled: CompiledReconfig,
    rst: ReconfigState,
    round_idx: int,
    horizon: int,
) -> torch.Tensor:
    """bool[G]: groups with a conf entry in flight or an op due to become
    eligible within the next `horizon` rounds, the mask steady_mask must
    reject (a fused horizon cannot propose, gate or apply a conf change).
    It guards each planned fused block of the split runner: an op whose
    retries outlive its planned window keeps its group's blocks on the
    general path until the op applies."""
    start = _gather_op(compiled.op_start, rst.op_ptr)
    has_op = rst.op_ptr < compiled.n_ops
    return (rst.stage > 0) | (has_op & (start < round_idx + horizon))


# --- split-horizon planning -------------------------------------------------


class HorizonSegment(NamedTuple):
    """One planned stretch of a runner horizon (host-side ints).

    start:  absolute round index of the segment's first round.
    rounds: segment length (>= 1).
    fused:  True = a whole number of k-round fused blocks (each still
            guarded at run time by the steady predicate and
            pending_in_horizon, so the plan is a hint, never an
            assumption); False = per-round general rounds (the op
            windows, phase-cut remainders, fused spans shorter than one
            block).
    """

    start: int
    rounds: int
    fused: bool


def plan_split_points(
    n_rounds: int,
    windows: Sequence[Tuple[int, int]],
    cuts: Sequence[int] = (),
    k: int = 8,
) -> List[HorizonSegment]:
    """Lower op windows and schedule-phase cuts to an ordered segment list.

    windows: half-open (start, end) general intervals, where scheduled
             conf-change ops propose, gate and apply (overlaps merge).
    cuts:    round indices a fused block may not span (phase starts: the
             append workload and fault masks change there).
    k:       fused block length in rounds.

    Returns segments covering [0, n_rounds) exactly, in order.  Fused
    segments have rounds % k == 0 (remainders become general segments),
    and no windows and no interior cuts give ONE fused segment (plus a
    general remainder when n_rounds % k != 0).
    """
    R = int(n_rounds)
    if R < 1:
        raise ValueError("n_rounds must be >= 1")
    if k < 1:
        raise ValueError("k must be >= 1")
    ivs = sorted(
        (max(0, int(a)), min(R, int(b)))
        for a, b in windows
        if int(b) > 0 and int(a) < R and int(b) > int(a)
    )
    merged: List[Tuple[int, int]] = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    cutset = sorted({int(c) for c in cuts if 0 < int(c) < R})
    segs: List[HorizonSegment] = []

    def emit_fused_span(a: int, b: int) -> None:
        points = [a] + [c for c in cutset if a < c < b] + [b]
        for lo, hi in zip(points, points[1:]):
            nb = (hi - lo) // k
            if nb:
                segs.append(HorizonSegment(lo, nb * k, True))
            rem = (hi - lo) - nb * k
            if rem:
                segs.append(HorizonSegment(lo + nb * k, rem, False))

    pos = 0
    for a, b in merged:
        if a > pos:
            emit_fused_span(pos, a)
        segs.append(HorizonSegment(a, b - a, False))
        pos = b
    if pos < R:
        emit_fused_span(pos, R)
    # Coalesce adjacent general segments.
    out: List[HorizonSegment] = []
    for s in segs:
        if (
            out
            and not s.fused
            and not out[-1].fused
            and out[-1].start + out[-1].rounds == s.start
        ):
            out[-1] = HorizonSegment(
                out[-1].start, out[-1].rounds + s.rounds, False
            )
        else:
            out.append(s)
    return out


def split_plan(
    compiled: CompiledReconfig,
    k: int = 8,
    chaos_compiled: Optional[chaos_mod.CompiledChaos] = None,
    window: int = 4,
) -> List[HorizonSegment]:
    """Where the compiled schedule's horizon splits into fused steady blocks
    and general op rounds.  Each scheduled op start opens a `window`-round
    general window (propose, dual-majority gate and apply complete in one
    round on a steady fleet; the window absorbs short retry tails).  A
    joint-entering op (its target has outgoing voters) extends its window
    to the selected groups' next op start + window, or to the horizon end
    when a selected group's chain ends joint: a joint config is never
    steady, so planning it fused would only buy rejected blocks.  Fused
    spans also split at every reconfig and chaos phase start, where the
    append workload and fault masks change."""
    R = compiled.n_rounds
    op_start = compiled.op_start.cpu().numpy()  # [K, G]
    n_ops = compiled.n_ops.cpu().numpy()  # [G]
    tgt_out = compiled.tgt_outgoing.cpu().numpy()  # [K, P, G]
    phase_of_round = compiled.phase_of_round.numpy()
    K = op_start.shape[0]
    windows: List[Tuple[int, int]] = []
    for ki in range(K):
        valid = (ki < n_ops) & (op_start[ki] < NO_ROUND)
        if not valid.any():
            continue
        for s in np.unique(op_start[ki][valid]):
            sel = valid & (op_start[ki] == s)
            end = int(s) + window
            if tgt_out[ki][:, sel].any():
                # Joint-entering op: general until the leave applies.
                if ki + 1 < K:
                    nxt = op_start[ki + 1][sel]
                    has_next = (n_ops[sel] > ki + 1) & (nxt < NO_ROUND)
                    if bool(has_next.all()):
                        end = int(nxt.max()) + window
                    else:
                        end = R
                else:
                    end = R
            windows.append((int(s), min(end, R)))
    cuts = set((np.flatnonzero(np.diff(phase_of_round)) + 1).tolist())
    if chaos_compiled is not None:
        cph = chaos_compiled.phase_of_round.numpy()
        cuts |= set((np.flatnonzero(np.diff(cph)) + 1).tolist())
    return plan_split_points(R, windows, sorted(cuts), k)


def _validate_plans(
    cfg: sim_mod.SimConfig,
    compiled: CompiledReconfig,
    chaos_compiled: Optional[chaos_mod.CompiledChaos],
) -> None:
    """The runners' shared input checks: equal horizons, agreeing peer
    counts and batch widths."""
    if chaos_compiled is not None:
        if chaos_compiled.n_rounds != compiled.n_rounds:
            raise ValueError(
                f"chaos plan spans {chaos_compiled.n_rounds} rounds but "
                f"the reconfig plan spans {compiled.n_rounds} — phases "
                "must cover the same horizon to compose in one run"
            )
        if chaos_compiled.n_peers != compiled.n_peers:
            raise ValueError("chaos and reconfig plans disagree on peers")
    if compiled.n_peers != cfg.n_peers:
        raise ValueError(
            f"plan has {compiled.n_peers} peers but cfg.n_peers == "
            f"{cfg.n_peers}"
        )
    if compiled.append.shape[1] != cfg.n_groups:
        raise ValueError(
            f"the schedule is compiled for {compiled.append.shape[1]} groups, "
            f"the config has {cfg.n_groups}"
        )


def _runner_body(
    cfg: sim_mod.SimConfig,
    sched: CompiledReconfig,
    chaos_sched: Optional[chaos_mod.CompiledChaos],
    with_counters: bool = False,
    actions: Optional[Tuple] = None,
    client=None,
):
    """One general round of the compiled reconfig(+chaos) scenario,
    body(carry, r) -> carry' for the absolute round index r (a Python int):
    the single source of the op propose/gate/apply protocol, shared by
    make_runner and make_split_runner's general segments and rejected fused
    blocks, and by the client-workload runners.  Carry: (state, health,
    rstate, stats, rstats, safety), with the [N_COUNTERS] int32 plane
    appended when `with_counters`.

    `client` (a workload.CompiledClient) appends (read_carry,
    read_stats[workload.N_READ_STATS], lat_hist[workload.N_LAT_BUCKETS]) to
    the carry: each round adds the phase's append skew, fires the
    schedule's reads (one read in flight a group: a fire finding one
    outstanding is dropped), retries outstanding reads through
    `sim.step(read_propose=)`, folds each served read's latency in rounds
    into the histogram, and runs check_safety's linearizability slots on
    the round-entry lease-holder mask beside the joint-window audit.

    `actions` (the autopilot's actuation) is an (action_round, transfer
    int32[G], kick bool[P, G]) triple: at the round whose absolute index
    is action_round the transfer commands and campaign kicks go to
    sim.step, and every other round passes all-zero planes.

    With SimConfig(blackbox=True) the carry gains a trailing
    sim.BlackboxState: each round audits with kernels.check_safety_groups
    instead of check_safety (the per-slot sums are the same counts) and
    folds the audit and the round-exit record into it in one
    kernels.blackbox_fold."""
    P, G = cfg.n_peers, cfg.n_groups
    dev = sched.append.device
    no_crash = torch.zeros((P, G), dtype=torch.bool, device=dev)
    if actions is not None:
        act_round, act_transfer, act_kick = actions
        no_transfer = torch.zeros((G,), dtype=I32, device=dev)

    def body(carry, r: int):
        if cfg.blackbox:
            carry, bb = carry[:-1], carry[-1]
        if client is not None:
            carry, (rcar, rdstats, lat_hist) = carry[:-3], carry[-3:]
        if with_counters:
            st, hl, rst, stats, rstats, safety, ctrs = carry
        else:
            st, hl, rst, stats, rstats, safety = carry
            ctrs = None
        append = sched.append[int(sched.phase_of_round[r])]
        if chaos_sched is not None:
            link, crashed, capp = chaos_mod.schedule_masks(chaos_sched, r)
            append = append + capp
        else:
            link, crashed = None, no_crash
        transfer_propose = campaign_kick = None
        if actions is not None:
            fire = r == act_round
            transfer_propose = act_transfer if fire else no_transfer
            campaign_kick = act_kick if fire else no_crash
        read_propose = lease_holder = lease_fire = None
        if client is not None:
            # The round's client traffic: the phase's append skew and the
            # read fires; an outstanding read retries every round until
            # served, and a fire finding one outstanding is dropped.
            cph = int(client.phase_of_round[r])
            append = append + client.append[cph]
            mode_row = client.read_mode[cph]
            fire = kernels.unpack_bits_g(client.read_fire_packed[r], G) & (mode_row > 0)
            fresh = fire & (rcar.pending_mode == 0)
            dropped = fire & (rcar.pending_mode > 0)
            pmode = torch.where(fresh, mode_row, rcar.pending_mode)
            psince = torch.where(fresh, r, rcar.pending_since)
            read_propose = pmode
            # The linearizability audit's inputs, off the round-entry
            # (serve-time) state: the lease holders and the groups with a
            # lease-mode read live this round.
            lease_holder, _, _ = kernels.lease_read(
                st.state, st.term, st.leader_id, st.election_elapsed,
                st.commit, st.term_start_index, crashed, cfg.election_tick,
                cfg.check_quorum and cfg.lease_read, st.transferee,
                st.recent_active, st.voter_mask, st.outgoing_mask,
            )
            lease_fire = pmode == sim_mod.READ_LEASE
        # Op eligibility: the next unapplied op, once its phase starts.
        start = _gather_op(sched.op_start, rst.op_ptr)
        active = (rst.op_ptr < sched.n_ops) & (start <= r)
        want_prop = active & (rst.stage == 0)
        prev_leaderless = hl.planes[HP_LEADERLESS]
        out = sim_mod.step(
            cfg, st, crashed, append + want_prop.to(I32),
            counters=ctrs, health=hl, link=link, reconfig_propose=want_prop,
            transfer_propose=transfer_propose, campaign_kick=campaign_kick,
            read_propose=read_propose,
        )
        if client is not None:
            out, receipt = out[:-1], out[-1]
        if with_counters:
            st2, ctrs2, hl2, prop = out
        else:
            st2, hl2, prop = out
            ctrs2 = None
        # Where the conf entry landed (owner 0 = no alive leader this
        # round; the op stays at stage 0 and retries).
        got = want_prop & (prop.owner > 0)
        stage = torch.where(got, 1, rst.stage)
        powner = torch.where(got, prop.owner, rst.prop_owner)
        pindex = torch.where(got, prop.index, rst.prop_index)
        pterm = torch.where(got, prop.term, rst.prop_term)
        # The dual-majority commit gate off the post-round planes: the
        # owner still leads at its propose term and is not crashed, and its
        # commit covers the entry (commit already needs both majorities of
        # a joint config).
        own_lead = (
            (_gather_peer(st2.state, powner) == kernels.ROLE_LEADER)
            & (_gather_peer(st2.term, powner) == pterm)
            & ~_gather_peer(crashed, powner)
        )
        committed = _gather_peer(st2.commit, powner) >= pindex
        apply_mask = (stage == 1) & own_lead & committed
        retry = (stage == 1) & ~own_lead
        stage = torch.where(apply_mask | retry, 0, stage)
        # The joint-window invariants on the post-step (pre-apply) state
        # under the masks that governed the step; the transition pair
        # (previous round's step masks -> this round's) audits the previous
        # round's apply.
        audit = dict(
            voter_mask=st2.voter_mask,
            outgoing_mask=st2.outgoing_mask,
            matched=st2.matched,
            crashed=crashed,
            prev_voter_mask=rst.prev_voter,
            prev_outgoing_mask=rst.prev_outgoing,
            lease_holder=lease_holder,
            lease_fire=lease_fire,
        )
        cursors = (st2.state, st2.term, st2.commit, st2.last_index, st2.agree,
                   st.commit)
        if cfg.blackbox:
            viol = kernels.check_safety_groups(*cursors, **audit)
            safety = safety + viol.sum(1, dtype=I32)
        else:
            safety = safety + kernels.check_safety(*cursors, **audit)
        # The gated swap: the target masks of the op being applied.
        (
            state3, leader3, commit3, matched3, vm3, om3, lm3, ra3, tr3,
        ) = kernels.apply_confchange(
            st2.state, st2.leader_id, st2.commit, st2.term_start_index,
            st2.matched, st2.voter_mask, st2.outgoing_mask,
            st2.learner_mask,
            _gather_op(sched.tgt_voter, rst.op_ptr),
            _gather_op(sched.tgt_outgoing, rst.op_ptr),
            _gather_op(sched.tgt_learner, rst.op_ptr),
            _gather_op(sched.added, rst.op_ptr),
            _gather_op(sched.removed, rst.op_ptr),
            apply_mask,
            st2.recent_active,
            st2.transferee,
        )
        st3 = st2._replace(
            state=state3, leader_id=leader3, commit=commit3,
            matched=matched3, voter_mask=vm3, outgoing_mask=om3,
            learner_mask=lm3, recent_active=ra3, transferee=tr3,
        )
        stats = chaos_mod.update_chaos_stats(
            stats, prev_leaderless, hl2.planes[HP_LEADERLESS]
        )
        rstats = rstats + torch.stack([
            got.sum(dtype=I32),
            apply_mask.sum(dtype=I32),
            retry.sum(dtype=I32),
            om3.any(0).sum(dtype=I32),
        ])
        rst2 = ReconfigState(
            stage=stage,
            op_ptr=torch.where(apply_mask, rst.op_ptr + 1, rst.op_ptr),
            prop_owner=powner,
            prop_index=pindex,
            prop_term=pterm,
            prev_voter=st2.voter_mask,
            prev_outgoing=st2.outgoing_mask,
        )
        out = (st3, hl2, rst2, stats, rstats, safety)
        if with_counters:
            out = out + (ctrs2,)
        if client is not None:
            # Serve accounting: a non-negative receipt closes the group's
            # outstanding read, its latency (r - issue round, capped at the
            # histogram's last bucket) folded into the histogram.
            lat_cap = lat_hist.shape[0] - 1
            served = (receipt.index >= 0) & (pmode > 0)
            lat = torch.clamp(r - psince, 0, lat_cap)
            lat_hist = lat_hist.scatter_add(
                0, torch.where(served, lat, 0).to(torch.int64), served.to(I32)
            )
            rdstats = rdstats + torch.stack([
                fresh.sum(dtype=I32),
                (served & receipt.lease).sum(dtype=I32),
                (served & ~receipt.lease).sum(dtype=I32),
                (served & receipt.degraded).sum(dtype=I32),
                ((pmode > 0) & ~served).sum(dtype=I32),
                dropped.sum(dtype=I32),
            ])
            rcar = type(rcar)(
                pending_mode=torch.where(served, 0, pmode),
                pending_since=torch.where(served, 0, psince),
            )
            out = out + (rcar, rdstats, lat_hist)
        if cfg.blackbox:
            # The ring records the round-exit (post-apply) state with the
            # audit's fired bits.
            out = out + (sim_mod.BlackboxState(*kernels.blackbox_fold(
                *bb, st3.state, st3.term, st3.commit, crashed, viol
            )),)
        return out

    return body


def _tail_audit(safety: torch.Tensor, st: sim_mod.SimState,
                rst: ReconfigState, bb=None):
    """The one extra fold after the last round: the body checks each
    apply's mask transition one round later, so a final-round apply needs
    it (prev_commit = the final commit keeps the commit checks inert).
    Returns (safety', bb'): with a BlackboxState `bb` the audit runs per
    group and its bits stamp the last folded round (kernels.blackbox_mark);
    bb' is None without one."""
    args = (st.state, st.term, st.commit, st.last_index, st.agree, st.commit)
    audit = dict(
        voter_mask=st.voter_mask,
        outgoing_mask=st.outgoing_mask,
        matched=st.matched,
        prev_voter_mask=rst.prev_voter,
        prev_outgoing_mask=rst.prev_outgoing,
    )
    if bb is None:
        return safety + kernels.check_safety(*args, **audit), None
    viol = kernels.check_safety_groups(*args, **audit)
    meta, trip = kernels.blackbox_mark(bb.meta, bb.trip_round, bb.round_idx, viol)
    return safety + viol.sum(1, dtype=I32), bb._replace(meta=meta, trip_round=trip)


def _zero_accumulators(dev):
    return (
        torch.zeros((chaos_mod.N_CHAOS_STATS,), dtype=I32, device=dev),
        torch.zeros((N_RECONFIG_STATS,), dtype=I32, device=dev),
        torch.zeros((N_SAFETY,), dtype=I32, device=dev),
    )


def _check_device(st, hl, dev):
    if st.term.device != dev or hl.planes.device != dev:
        raise ValueError(
            f"the state and health planes must lie on the schedule's device "
            f"{dev}, got {st.term.device} and {hl.planes.device}"
        )


def make_runner(
    cfg: sim_mod.SimConfig,
    compiled: CompiledReconfig,
    chaos_compiled: Optional[chaos_mod.CompiledChaos] = None,
):
    """The whole-scenario runner: fn(state, health, rstate) -> (state',
    health', rstate', stats int32[N_CHAOS_STATS], rstats
    int32[N_RECONFIG_STATS], safety int32[N_SAFETY]), every round of the
    compiled schedule through _runner_body, then the tail audit.
    `chaos_compiled` (optional, equal n_rounds and n_peers) threads a
    compiled fault schedule through the same rounds, so membership changes
    run during partitions.  The loop adds no host sync of its own (the
    step's election gate has one a round unless SimConfig(spmd=True)); the
    results stay on the device.  With SimConfig(blackbox=True) it is
    fn(state, health, rstate, blackbox), and blackbox' comes last."""
    from . import runner as runner_mod

    return runner_mod.make_runner(cfg, (compiled, chaos_compiled))


def make_split_runner(
    cfg: sim_mod.SimConfig,
    compiled: CompiledReconfig,
    chaos_compiled: Optional[chaos_mod.CompiledChaos] = None,
    k: int = 8,
    window: int = 4,
    with_counters: bool = False,
):
    """The split-horizon scenario runner: make_runner's protocol, with the
    same end state, health planes, op-protocol carry and stats and safety
    accumulators, but the horizon split at the op windows (`split_plan`)
    so that the steady stretches between ops run the fused kernel.

    General segments run _runner_body round by round.  Each planned fused
    k-round block checks fused_step.steady_mask(reconfig_pending=
    pending_in_horizon(...), link=, loss_rate=) over the whole batch (one
    host bool() a block) and runs either the fused kernel, with the health
    planes (fused_step.steady_round, or chaos_round with a chaos overlay;
    the damped kernel for a damped config), or the same k general rounds.
    A fused block cannot move the op-protocol carry, the masks, the rstats
    or the safety accumulator (no op is due, the config is not joint, and
    every check_safety slot is zero on a steady horizon), its MTTR fold is
    the closed form of k leaderful rounds, and only prev_voter and
    prev_outgoing refresh.

    `with_counters` threads the [N_COUNTERS] int32 plane through both
    branches.  Returns runner(st, hl, rst[, counters]) -> (st', hl', rst',
    stats, rstats, safety, fused_rounds[, counters']), `fused_rounds` a
    Python int of fused group-rounds (k x n_groups per fused block that
    ran), so fused_frac = fused_rounds / (compiled.n_rounds x n_groups).
    `runner.segments` is the plan's segment list, and `runner.blocks` lists
    the last call's planned fused blocks as (first round, fused) pairs."""
    from . import runner as runner_mod

    return runner_mod.make_runner(
        cfg, (compiled, chaos_compiled), split=True, k=k, window=window,
        with_counters=with_counters,
    )


def run_plan(
    cfg: sim_mod.SimConfig,
    state: sim_mod.SimState,
    compiled: CompiledReconfig,
    health: Optional[sim_mod.HealthState] = None,
    rstate: Optional[ReconfigState] = None,
    chaos_compiled: Optional[chaos_mod.CompiledChaos] = None,
):
    """Execute a whole compiled reconfig(+chaos) scenario: (state', health',
    rstate', stats, rstats, safety), all on the schedule's device.  The
    health planes are required (the MTTR stats ride on HP_LEADERLESS):
    None starts fresh ones, as None does a fresh op-protocol state."""
    if health is None:
        health = sim_mod.init_health(cfg, state.term.device)
    if rstate is None:
        rstate = init_reconfig_state(state)
    return make_runner(cfg, compiled, chaos_compiled)(state, health, rstate)
