"""ClusterSim in PyTorch: G Raft groups × P peers in peer-major [P, G]
tensors, advanced one lockstep protocol round at a time.

Counterpart of `raft_tpu/multiraft/sim.py`, reduced to what the ported
paths run: `SimConfig` (:117), `SimState` (:226), `HealthState` (:287),
`init_health` (:302), `_node_key` with `group_ids` (:511), `init_state`
(:528), `_sort_rows_desc` (:621), `_quorum_index` (:635), the plain arm of
`step` (:1209-1773: undamped, `link=None`), the link-gated round
`_linked_step` (:1792-2428, undamped) behind `step(link=)`, the damped
round `_damped_linked_step` (:2451-3548: check quorum and pre-vote) that
`step` runs for every config with either flag, each with the `counters`
and `health` extras, the `reconfig_propose` extra (`ReconfigProposal`,
:342) and `group_ids` (a gathered sub-batch keyed by its global ids), the client
reads behind `step(read_propose=)` on all three rounds (`READ_*` and
`ReadReceipt`, :357-384; `_read_quorum_damped`, :387; `_read_phase`, :468;
the Safe-mode barrier `read_index`, :3573), and `ClusterSim` with
`__init__` (:3657-3785, with `chaos=` and `mesh=`), the mesh placement
(:3821-3848, :4177-4226), `run_round` (:3950), `run`
(:4005), the counter drain (:3851-3948), the chaos scenario runner
`_chaos_runner_for` and `run_plan` (:4227-4295), `run_reconfig`
(:4299-4505), the client-read workload `run_reads` (:4506-4638),
the counter and health accessors (:4639-4745) and the read probes
`read_index` and `lease_read` (:4822-4860).  The black box
(SimConfig(blackbox=True)) adds `BlackboxState` and `init_blackbox`
(:310-341), the `step(blackbox=)` wrapper (:1146-1173) on all three rounds,
`ClusterSim`'s recorder, its drain capture and `record_safety`,
`forensics`, `incident_report` and `reset_forensics` (:4747-4821), and the
black-box arms of `run_plan`, `run_reconfig` and `run_reads`.  Leader transfer
(SimConfig(transfer=True)) adds the `transferee` plane and the pre-tick
pump `_transfer_phase` (:651-1067) behind `step(transfer_propose=,
campaign_kick=)` on all three rounds.  Each round is the reference's round exactly,
plane by plane: tick, campaign, election resolution (vote grants, joint
tallies, commit fast-forward via vote traffic), the solo
crashed-campaigner win, then replication and quorum commit; the linked and
damped rounds replay the same protocol wave by wave over the directed
delivery plane.

The reference gates the election phase behind `lax.cond(any(req))`.
Here that is a host-side `if`, one device sync per general round; with
`SimConfig(spmd=True)` the phase runs unconditionally as masked ops (no
sync, some hundreds more small launches), which is bit-identical because
every write inside it is masked on this round's campaigners.

Tensors are never updated in place: every round returns fresh planes, like
the reference's pure step, so a caller may keep the previous state.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import profiling
from . import graphs, kernels, planes
from .kernels import (
    ROLE_CANDIDATE,
    ROLE_FOLLOWER,
    ROLE_LEADER,
    ROLE_PRE_CANDIDATE,
)
from .health import HealthMonitor
from .platform import DeviceLike, resolve_device

I32 = torch.int32


class GroupShard(NamedTuple):
    """One rank's block of a mesh run (sharding.py): the global group ids
    [lo, hi) of its planes, the global batch width and the mesh whose
    collectives make the run's whole-batch decisions."""

    lo: int
    hi: int
    n_groups: int
    mesh: object


class SimConfig(NamedTuple):
    """Static per-sim configuration; same fields, order and defaults as the
    reference's SimConfig: the undamped and damped (`check_quorum`,
    `pre_vote`) rounds, the counters and health instrumentation, lease
    reads (`lease_read`, which needs `check_quorum`), leader transfer
    (`transfer`) and the black box (`blackbox`, a `blackbox_window`-round
    ring and a `blackbox_topk`-wide capture).  `shard` is None: a rank's
    block of a mesh run has a ShardConfig instead."""

    n_groups: int
    n_peers: int
    election_tick: int = 10
    heartbeat_tick: int = 1
    collect_counters: bool = False
    collect_health: bool = False
    health_window: int = 32
    leaderless_stall_ticks: int = 16
    commit_stall_ticks: int = 32
    churn_bumps: int = 4
    health_topk: int = 8
    check_quorum: bool = False
    pre_vote: bool = False
    transfer: bool = False
    lease_read: bool = False
    blackbox: bool = False
    blackbox_window: int = 8
    blackbox_topk: int = 8
    # Run the election phase unconditionally as masked ops instead of
    # behind a host-side `if any(campaigners)` (no device sync per round).
    spmd: bool = False

    @property
    def shard(self) -> Optional[GroupShard]:
        return None

    @property
    def min_timeout(self) -> int:
        return self.election_tick

    @property
    def max_timeout(self) -> int:
        return 2 * self.election_tick


class SimState(NamedTuple):
    """SoA state, peer-major [P, G] int32/bool; same fields and order as the
    reference's SimState.  `recent_active` is the damped configs' plane
    (None for undamped ones, as in the reference); `transferee` is each
    peer's lead_transferee slot (0 = none, else the 1-based target), only
    with SimConfig(transfer=True) and None otherwise."""

    term: torch.Tensor  # int32[P, G]
    state: torch.Tensor  # int32[P, G] — ROLE_* codes
    vote: torch.Tensor  # int32[P, G] — 0 = none, else peer id (1..P)
    leader_id: torch.Tensor  # int32[P, G] — each peer's view; 0 = none
    election_elapsed: torch.Tensor  # int32[P, G]
    heartbeat_elapsed: torch.Tensor  # int32[P, G]
    randomized_timeout: torch.Tensor  # int32[P, G]
    last_index: torch.Tensor  # int32[P, G]
    last_term: torch.Tensor  # int32[P, G]
    commit: torch.Tensor  # int32[P, G]
    matched: torch.Tensor  # int32[P, P, G] — per-OWNER Progress.matched
    term_start_index: torch.Tensor  # int32[P, G] — owner's noop index
    agree: torch.Tensor  # int32[P, P, G] — pairwise common-prefix length
    voter_mask: torch.Tensor  # bool[P, G]
    outgoing_mask: torch.Tensor  # bool[P, G] — all False = not joint
    learner_mask: torch.Tensor  # bool[P, G]
    recent_active: Optional[torch.Tensor] = None  # bool[P, P, G] — per-owner
    transferee: Optional[torch.Tensor] = None  # int32[P, G]


class HealthState(NamedTuple):
    """Fleet-health telemetry carried beside SimState.

    planes:     [kernels.N_HEALTH_PLANES, G] int32 per-group planes (row
                indices kernels.HP_*), updated once a round by
                kernels.update_health on the state's device; only the
                kernels.health_summary reduction crosses to the host.
    window_pos: rounds into the current churn window, a Python int (the
                reference's device int32 scalar; every change to it is
                host-known arithmetic, so it needs no device sync)."""

    planes: torch.Tensor  # int32[N_HEALTH_PLANES, G]
    window_pos: int


def init_health(cfg: SimConfig, device: DeviceLike = None) -> HealthState:
    """Fresh all-zero health state for cfg.n_groups groups, on `cuda`
    unless `device` says otherwise."""
    return HealthState(kernels.zero_health(cfg.n_groups, device), 0)


class BlackboxState(NamedTuple):
    """The black-box flight recorder carried beside SimState when
    SimConfig.blackbox is on.

    meta:       int32[W, G] ring of packed per-round records (W =
                SimConfig.blackbox_window, slot = round % W): group max
                role, acting leader id and the round's fired safety slots
                (kernels.pack_blackbox_meta; the reference's uint32 bits).
    term:       int32[W, G] group max term per ring slot.
    commit:     int32[W, G] group max commit per ring slot.
    trip_round: int32[kernels.N_SAFETY, G] first round each safety slot
                fired in each group (kernels.INF = never), which
                kernels.blackbox_capture reduces to the fixed-size capture.
    round_idx:  rounds folded so far, a Python int (the reference's device
                int32 scalar; it only ever counts host-known rounds)."""

    meta: torch.Tensor
    term: torch.Tensor
    commit: torch.Tensor
    trip_round: torch.Tensor
    round_idx: int


def init_blackbox(cfg: SimConfig, device: DeviceLike = None) -> BlackboxState:
    """A fresh (all-zero ring, never-tripped) black box for cfg.n_groups
    groups, on `cuda` unless `device` says otherwise."""
    return BlackboxState(*kernels.zero_blackbox(
        cfg.n_groups, cfg.blackbox_window, device
    ))


def blackbox_to_numpy(bb: BlackboxState) -> Dict[str, object]:
    """{field: numpy array} of a BlackboxState, meta as np.uint32 (the
    reference's dtype) and round_idx as an int."""
    out = {name: getattr(bb, name).cpu().numpy() for name in BlackboxState._fields[:4]}
    out["meta"] = out["meta"].view(np.uint32)
    out["round_idx"] = int(bb.round_idx)
    return out


def blackbox_from_numpy(arrays: Dict[str, object], device: DeviceLike = None) -> BlackboxState:
    """The inverse of blackbox_to_numpy; meta may be uint32 (the reference's)
    or int32 words."""
    dev = resolve_device(device)

    def plane(name):
        a = np.ascontiguousarray(arrays[name])
        a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
        return torch.from_numpy(a.copy()).to(dev)

    return BlackboxState(
        plane("meta"), plane("term"), plane("commit"), plane("trip_round"),
        int(arrays["round_idx"]),
    )


def check_blackbox_arg(cfg: SimConfig, bb: tuple) -> None:
    """The runners' rule for their trailing black-box argument: a black-box
    config's runner takes the BlackboxState, any other config's none."""
    if len(bb) != int(cfg.blackbox):
        raise TypeError(
            "a black-box config's runner takes the BlackboxState (after the "
            "carries it threads), any other config's none"
        )


class ReconfigProposal(NamedTuple):
    """Where this round's conf-change entry landed, per group (the step
    extra behind `step(reconfig_propose=)`): owner is the acting leader's
    peer id (0 = no alive leader, nothing proposed), index the entry's log
    index (the round's workload plus the conf entry, appended last), term
    the owner's term at propose time.  The reconfig runner records them as
    the pending entry whose commit under both majorities gates the mask
    swap."""

    owner: torch.Tensor  # int32[G]
    index: torch.Tensor  # int32[G]
    term: torch.Tensor  # int32[G]


# Read-request modes for step(read_propose=): int32[G] per-group commands,
# ReadOnlyOption + 1 (0 is "no read this round").
READ_NONE = 0
READ_SAFE = 1  # the ReadIndex quorum round (ReadOnlyOption::Safe)
READ_LEASE = 2  # local serve under the lease (ReadOnlyOption::LeaseBased)


class ReadReceipt(NamedTuple):
    """What this round's client reads returned, per group (the step extra
    behind `step(read_propose=)`): `index` is the commit index the acting
    leader served (-1: the read did not complete this round and the caller
    retries it), `lease` marks reads served locally under the check-quorum
    lease (kernels.lease_read), and `degraded` marks LeaseBased requests
    that fell back to the ReadIndex quorum round (the decision, recorded
    even when the fallback failed too).  Reads are probes: the receipt is
    computed on the round-entry state, and the round's protocol phases
    never see the read traffic."""

    index: torch.Tensor  # int32[G]
    lease: torch.Tensor  # bool[G]
    degraded: torch.Tensor  # bool[G]


class _RoundFacts(NamedTuple):
    """What a round's counters and health fold read besides the (pre,
    post) state pair."""

    want_campaign: torch.Tensor  # bool[P, G]: election timers fired
    beats: torch.Tensor  # bool[P, G]: heartbeat timers fired and sent
    won: torch.Tensor  # bool[G]: a leader was elected this round
    # bool[P, G]: the pre-vote winners' real campaign() calls, or None.
    real_campaigns: Optional[torch.Tensor] = None
    # The health fold reads `won` off the end-of-round state instead: a
    # winner deposed later in the same round does not count.
    observed_won: bool = False
    # (has_leader bool[G], first_l int32[G] (0-based), lead_last int32[G],
    # lead_term int32[G]): the acting leader and its log tip after the
    # round's appends, which step(reconfig_propose=) reports.
    lead: Optional[tuple] = None
    # bool[G]: groups whose proposals a pending transfer dropped, or None
    # without a transferee plane.
    blocked: Optional[torch.Tensor] = None


_BOOL_FIELDS = ("voter_mask", "outgoing_mask", "learner_mask", "recent_active")


def state_from_numpy(
    arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> SimState:
    """Build a SimState from numpy planes keyed by field name (bool planes
    to torch.bool, every other plane to torch.int32).  Absent or None
    optional planes stay None."""
    dev = resolve_device(device)
    fields = {}
    for name in SimState._fields:
        a = arrays.get(name)
        if a is None:
            fields[name] = None
            continue
        dtype = torch.bool if name in _BOOL_FIELDS else I32
        np_dtype = np.bool_ if dtype is torch.bool else np.int32
        # A copy: numpy views of other frameworks' buffers are read-only.
        fields[name] = torch.from_numpy(
            np.array(a, dtype=np_dtype, order="C", copy=True)
        ).to(dev)
    return SimState(**fields)


def state_to_numpy(st: SimState) -> Dict[str, np.ndarray]:
    """The inverse of state_from_numpy: {field: numpy array} for every
    non-None plane."""
    return {
        name: getattr(st, name).cpu().numpy()
        for name in SimState._fields
        if getattr(st, name) is not None
    }


class ShardConfig(SimConfig):
    """The config of a rank's block of a mesh run (sharding.local_config):
    the SimConfig fields, n_groups the block's width, plus the rank's
    GroupShard as `shard`, so every group-keyed draw keys on the global
    ids and the whole-batch decisions reduce over the mesh.  It equals, and
    hashes as, the plain SimConfig of its fields; _replace keeps the
    shard."""

    def __new__(cls, cfg: SimConfig, shard: GroupShard):
        self = tuple.__new__(cls, cfg)
        self._shard = shard
        return self

    @property
    def shard(self) -> GroupShard:
        return self._shard

    def _replace(self, **kw) -> "ShardConfig":
        return ShardConfig(SimConfig(*self)._replace(**kw), self._shard)


def group_base(cfg: SimConfig) -> int:
    """The global id of the first group of `cfg`'s planes: 0 off a mesh."""
    return 0 if cfg.shard is None else cfg.shard.lo


def global_groups(cfg: SimConfig) -> int:
    """The whole batch's width: cfg.n_groups off a mesh."""
    return cfg.n_groups if cfg.shard is None else cfg.shard.n_groups


def group_ids_of(cfg: SimConfig, device) -> Optional[torch.Tensor]:
    """The global ids of `cfg`'s groups as int64[G], or None off a mesh
    (where the iota is the ids)."""
    base = group_base(cfg)
    if base == 0:
        return None
    return torch.arange(base, base + cfg.n_groups, dtype=torch.int64, device=device)


def _node_key(
    cfg: SimConfig, device: torch.device, group_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """node_key[p, g] = g * 2**16 + (p + 1) mod 2**32 (the reference's
    uint32 arithmetic, which wraps for g >= 65536), as int64 words.
    `group_ids` (the GLOBAL ids of a gathered sub-batch) replace the
    iota, so each group keeps its own timeout stream; on a rank of a mesh
    run the iota starts at the rank's first global id."""
    if group_ids is None:
        base = group_base(cfg)
        g = torch.arange(base, base + cfg.n_groups, dtype=torch.int64, device=device)
    else:
        g = group_ids.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    g = g[None, :]
    p = torch.arange(cfg.n_peers, dtype=torch.int64, device=device)[:, None]
    return (g * (1 << 16) + (p + 1)) & 0xFFFFFFFF


def init_state(
    cfg: SimConfig,
    voter_mask: Optional[torch.Tensor] = None,
    outgoing_mask: Optional[torch.Tensor] = None,
    learner_mask: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
    group_ids: Optional[torch.Tensor] = None,
) -> SimState:
    """All peers start as followers at term 0 with their deterministic
    timeout draw (mirrors Raft.__init__ -> become_follower(0)); damped
    configs get an all-False recent_active plane, and transfer configs an
    all-zero transferee plane.  Runs on `cuda` unless
    `device` says otherwise.  `group_ids` (int[G]) are the groups' GLOBAL
    ids, which key the timeout draws: a shard of a mesh run draws exactly
    its block of the whole batch's streams."""
    dev = resolve_device(device)
    G, P = cfg.n_groups, cfg.n_peers
    shape = (P, G)

    def zeros():
        return torch.zeros(shape, dtype=I32, device=dev)

    def mask(m, fill):
        if m is None:
            return torch.full(shape, fill, dtype=torch.bool, device=dev)
        return m.to(device=dev, dtype=torch.bool)

    lo = torch.full(shape, cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full(shape, cfg.max_timeout, dtype=I32, device=dev)
    rt = kernels.timeout_draw(
        _node_key(cfg, dev, group_ids),
        torch.zeros(shape, dtype=torch.int64, device=dev),
        lo, hi,
    )
    return SimState(
        term=zeros(),
        state=zeros(),
        vote=zeros(),
        leader_id=zeros(),
        election_elapsed=zeros(),
        heartbeat_elapsed=zeros(),
        randomized_timeout=rt,
        last_index=zeros(),
        last_term=zeros(),
        commit=zeros(),
        matched=torch.zeros((P, P, G), dtype=I32, device=dev),
        term_start_index=zeros(),
        agree=torch.zeros((P, P, G), dtype=I32, device=dev),
        voter_mask=mask(voter_mask, True),
        outgoing_mask=mask(outgoing_mask, False),
        learner_mask=mask(learner_mask, False),
        recent_active=(
            torch.zeros((P, P, G), dtype=torch.bool, device=dev)
            if cfg.check_quorum or cfg.pre_vote
            else None
        ),
        transferee=zeros() if cfg.transfer else None,
    )


# The plane that rides run_compiled's graph carry bit-packed, from the
# registry (planes.py `packing == "bits_g"`; exactly one row, so the
# destructuring fails loudly if a second one lands without generalizing the
# carry).
(_PACKED_CARRY_FIELD,) = planes.packed_carry_fields()


def pack_ra_carry(st: SimState):
    """Split `st` into (state without recent_active, packed words) for a
    round carry: the optional recent_active bool[P, P, G] plane rides
    packed 32:1 along the group axis (kernels.pack_bits_g: int32[P, P,
    ceil(G/32)] words holding the reference's uint32 bits) between rounds.
    Undamped states pass through unchanged, with None words.  Inverse:
    unpack_ra_carry."""
    plane = getattr(st, _PACKED_CARRY_FIELD)
    if plane is None:
        return st, None
    return (
        st._replace(**{_PACKED_CARRY_FIELD: None}),
        kernels.pack_bits_g(plane),
    )


def unpack_ra_carry(st: SimState, words: Optional[torch.Tensor]) -> SimState:
    """Inverse of pack_ra_carry: restore the packed plane from its words
    (None words: an undamped state, returned unchanged)."""
    if words is None:
        return st
    n_groups = st.term.shape[-1]
    return st._replace(
        **{_PACKED_CARRY_FIELD: kernels.unpack_bits_g(words, n_groups)}
    )


def _sort_rows_desc(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Descending odd-even transposition sorting network over P rows of [G]
    vectors (the reference's replacement for a sort along the peer axis)."""
    n = len(rows)
    rows = list(rows)
    for pass_ in range(n):
        for i in range(pass_ % 2, n - 1, 2):
            hi = torch.maximum(rows[i], rows[i + 1])
            lo = torch.minimum(rows[i], rows[i + 1])
            rows[i], rows[i + 1] = hi, lo
    return rows


def _quorum_pick(
    matched: torch.Tensor, voter_mask: torch.Tensor, qpos: torch.Tensor
) -> torch.Tensor:
    """The value at position `qpos` [G] of each group's voter slots of
    `matched` [P, G] sorted in descending order (non-voters count as 0),
    by the odd-even network.  int32[G]."""
    P = matched.shape[0]
    rows = _sort_rows_desc(
        [torch.where(voter_mask[p], matched[p], 0) for p in range(P)]
    )
    out = torch.zeros_like(rows[0])
    for p in range(P):
        out = torch.where(qpos == p, rows[p], out)
    return out


def _quorum_index(matched: torch.Tensor, voter_mask: torch.Tensor) -> torch.Tensor:
    """Per-group majority commit index over the peer axis of [P, G] planes
    (reference: majority.rs:70-124); INF for an empty config.  int32[G]."""
    count = voter_mask.sum(0, dtype=I32)
    return torch.where(
        count == 0, kernels.INF, _quorum_pick(matched, voter_mask, count // 2)
    )


def _weighted_row(plane: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """sum over the owner axis of plane[o, ...] * f[o] in int32: the row of
    the one owner whose 0/1 weight f is set (zeros where none is)."""
    if plane.dim() == 3:
        f = f[:, None, :]
    return (plane * f).sum(0, dtype=I32)


def _draw(node_key: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
          term: torch.Tensor) -> torch.Tensor:
    """The randomized election timeouts of `term`: kernels.timeout_draw
    keyed on its low 32 bits, as the reference's rounds draw them."""
    with profiling.annotate("general.draw"):
        return kernels.timeout_draw(node_key, term.to(torch.int64) & 0xFFFFFFFF, lo, hi)


def _transfer_phase(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    transfer_propose: Optional[torch.Tensor],  # int32[G]
    link: Optional[torch.Tensor],  # bool[P, P, G]
    node_key: torch.Tensor,  # int64[P, G]
):
    """The pre-tick leader-transfer pump of all three rounds (the
    reference's `_transfer_phase`, sim.py:651-1067): returns (state',
    campaigned bool[G], won bool[G]).

    Before the round's ticks, each group's acting leader steps this
    round's MsgTransferLeader command (kernels.apply_transfer: the
    validation and the transfer-clock reset), then pumps its pending
    transfer: MsgTimeoutNow directly when a new command finds the target
    caught up, else the catch-up append (allow_empty), whose ack triggers
    MsgTimeoutNow when it made progress.  A target at the leader's term
    that receives MsgTimeoutNow campaigns at once (CAMPAIGN_TRANSFER: no
    pre-vote, leases bypassed), and the whole election resolves inside
    the pump: the vote requests, the responses in voter order with the
    scalar win/loss cutoffs and commit fast-forwards, the winner's noop
    append, broadcast and quorum commit.  Every hop is gated per directed
    link (`link`, or all-up among alive peers).  Under damping a catch-up
    append that reaches a higher-term target draws the low-term nudge,
    which deposes the stale leader.  Everything is masked on the groups
    with a pending transfer, so the others pass through unchanged."""
    G, P = cfg.n_groups, cfg.n_peers
    dev = st.term.device
    damped = cfg.check_quorum or cfg.pre_vote
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    eye = torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    E = alive[:, None, :] & alive[None, :, :] & ~eye
    if link is not None:
        E = link & E
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)

    draw = functools.partial(_draw, node_key, lo, hi)

    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask

    # ---- the acting leader before the round: the alive max-term leader,
    # the lowest index on a tie.
    is_lead = (st.state == ROLE_LEADER) & alive
    has_lead = is_lead.any(0)  # [G]
    lead_term = torch.where(is_lead, st.term, -1).amax(0)  # [G]
    acting = is_lead & (st.term == lead_term[None, :])
    first_l = torch.where(acting, p_idx, P).amin(0)  # [G]
    is_acting = (p_idx == first_l) & has_lead[None, :]
    acting_i = is_acting.to(I32)

    if transfer_propose is None:
        transfer_propose = torch.zeros((G,), dtype=I32, device=dev)
    T, ee0, accepted = kernels.apply_transfer(
        st.transferee, st.election_elapsed, is_acting, transfer_propose,
        member, st.learner_mask,
    )

    # The acting leader's pending target after the command; everything
    # below is masked on `active`.
    t_all = torch.where(is_acting, T, 0).sum(0, dtype=I32)
    active = has_lead & (t_all > 0)  # [G]
    is_tgt = (self_id == t_all[None, :]) & active[None, :]  # [P, G]

    lead_last = (st.last_index * acting_i).sum(0, dtype=I32)
    lead_lterm = (st.last_term * acting_i).sum(0, dtype=I32)
    lead_commit = (st.commit * acting_i).sum(0, dtype=I32)
    m_row = _weighted_row(st.matched, acting_i)  # [P, G]: the leader's row
    agree_lead = _weighted_row(st.agree, acting_i)  # [P, G]: agree[leader]
    matched_t = torch.where(is_tgt, m_row, 0).sum(0, dtype=I32)
    caught_pre = matched_t == lead_last
    term_t = torch.where(is_tgt, st.term, 0).sum(0, dtype=I32)

    # The directed leader <-> target links.
    E_lt = (E & is_acting[:, None, :] & is_tgt[None, :, :]).any(1).any(0)
    E_tl = (E & is_tgt[:, None, :] & is_acting[None, :, :]).any(1).any(0)

    # ---- hop 1: MsgTimeoutNow directly (a new command, the target caught
    # up) or the catch-up append.  The log and commit are adopted only on
    # a probe match or a live reverse link; a delivered append resets the
    # target's timers either way.
    tn_direct = active & accepted & caught_pre & E_lt
    ap_path = active & ~(accepted & caught_pre)
    del_ap = ap_path & E_lt & (term_t <= lead_term)
    lead_ts = (st.term_start_index * acting_i).sum(0, dtype=I32)
    prev_t = torch.where(matched_t == 0, lead_ts - 1, lead_last)
    agree_lt = torch.where(is_tgt, agree_lead, 0).sum(0, dtype=I32)
    adopt_ap = del_ap & ((agree_lt >= prev_t) | E_tl)
    sync = is_tgt & del_ap[None, :]
    adopt = is_tgt & adopt_ap[None, :]
    bump = sync & (st.term < lead_term[None, :])
    T_pl = torch.where(sync, lead_term[None, :], st.term)
    St_pl = torch.where(sync, ROLE_FOLLOWER, st.state)
    V_pl = torch.where(bump, 0, st.vote)
    Ld_pl = torch.where(sync, first_l[None, :] + 1, st.leader_id)
    EE_pl = torch.where(sync, 0, ee0)
    HB_pl = st.heartbeat_elapsed
    RT_pl = torch.where(bump, draw(T_pl), st.randomized_timeout)
    LI_pl = torch.where(adopt, lead_last[None, :], st.last_index)
    LT_pl = torch.where(adopt, lead_lterm[None, :], st.last_term)
    C_pl = torch.where(
        adopt, torch.maximum(st.commit, lead_commit[None, :]), st.commit
    )
    in_s = adopt | (is_acting & adopt_ap[None, :])
    agree_pl = _merge_agree(st.agree, in_s, lead_last, agree_lead)
    ack = adopt_ap & E_tl
    mack = is_acting[:, None, :] & is_tgt[None, :, :] & ack[None, None, :]
    matched_pl = torch.where(mack, lead_last[None, None, :], st.matched)
    RA = st.recent_active
    if RA is not None:
        RA = RA | mack
    if damped:
        # The low-term nudge: the catch-up append reaching a higher-term
        # target draws a response at the target's term, which deposes the
        # stale leader; reset() aborts the transfer.
        ndg = ap_path & E_lt & (term_t > lead_term) & E_tl
        dep = is_acting & ndg[None, :]
        T_pl = torch.where(dep, term_t[None, :], T_pl)
        St_pl = torch.where(dep, ROLE_FOLLOWER, St_pl)
        V_pl = torch.where(dep, 0, V_pl)
        Ld_pl = torch.where(dep, 0, Ld_pl)
        EE_pl = torch.where(dep, 0, EE_pl)
        HB_pl = torch.where(dep, 0, HB_pl)
        RT_pl = torch.where(dep, draw(T_pl), RT_pl)
        T = torch.where(dep, 0, T)

    # ---- hop 2: MsgTimeoutNow at the target.  A lower-term target first
    # takes the become_follower(m.term) bump; then only a follower at the
    # leader's term campaigns.  The ack-triggered send needs the ack to
    # have made progress, so a lost MsgTimeoutNow is never sent again and
    # the transfer hangs until the tick-time abort, as in raft-rs.
    tn = tn_direct | (ack & (matched_t < lead_last))
    tn_bump = is_tgt & tn[None, :] & (T_pl < lead_term[None, :])
    T_pl = torch.where(tn_bump, lead_term[None, :], T_pl)
    St_pl = torch.where(tn_bump, ROLE_FOLLOWER, St_pl)
    V_pl = torch.where(tn_bump, 0, V_pl)
    Ld_pl = torch.where(tn_bump, 0, Ld_pl)
    EE_pl = torch.where(tn_bump, 0, EE_pl)
    HB_pl = torch.where(tn_bump, 0, HB_pl)
    RT_pl = torch.where(tn_bump, draw(T_pl), RT_pl)
    campaign_mask = (
        is_tgt
        & tn[None, :]
        & (St_pl == ROLE_FOLLOWER)
        & (T_pl == lead_term[None, :])
        & promotable
    )
    cg = campaign_mask.any(0)  # [G]

    # ---- the forced campaign (CAMPAIGN_TRANSFER skips pre-vote).
    t_star = lead_term + 1  # [G]
    T_pl = torch.where(campaign_mask, t_star[None, :], T_pl)
    St_pl = torch.where(campaign_mask, ROLE_CANDIDATE, St_pl)
    V_pl = torch.where(campaign_mask, self_id, V_pl)
    Ld_pl = torch.where(campaign_mask, 0, Ld_pl)
    EE_pl = torch.where(campaign_mask, 0, EE_pl)
    HB_pl = torch.where(campaign_mask, 0, HB_pl)
    RT_pl = torch.where(campaign_mask, draw(T_pl), RT_pl)

    # ---- hop 3: the vote requests reach every voter over the target's
    # outbound links; the force context bypasses leases, and a lower-term
    # request is ignored silently.  The candidate's log is its
    # post-catch-up log.
    E_from_t = (E & is_tgt[:, None, :]).any(0)  # [P_v, G]
    E_to_t = (E & is_tgt[None, :, :]).any(1)  # [P_v, G]
    del_rq = cg[None, :] & promotable & ~is_tgt & E_from_t
    li_t = torch.where(is_tgt, LI_pl, 0).sum(0, dtype=I32)
    lt_t = torch.where(is_tgt, LT_pl, 0).sum(0, dtype=I32)
    c_t = torch.where(is_tgt, C_pl, 0).sum(0, dtype=I32)
    agree_t = _weighted_row(agree_pl, is_tgt.to(I32))  # [P_v, G]
    vbump = del_rq & (T_pl < t_star[None, :])
    at = del_rq & (T_pl <= t_star[None, :])
    T_pl = torch.where(vbump, t_star[None, :], T_pl)
    St_pl = torch.where(vbump, ROLE_FOLLOWER, St_pl)
    V_pl = torch.where(vbump, 0, V_pl)
    Ld_pl = torch.where(vbump, 0, Ld_pl)
    EE_pl = torch.where(vbump, 0, EE_pl)
    HB_pl = torch.where(vbump, 0, HB_pl)
    RT_pl = torch.where(vbump, draw(T_pl), RT_pl)
    up = (lt_t[None, :] > LT_pl) | (
        (lt_t[None, :] == LT_pl) & (li_t[None, :] >= LI_pl)
    )
    can = at & (((V_pl == 0) & (Ld_pl == 0)) | (V_pl == t_all[None, :]))
    grant = can & up
    rej = at & ~grant
    rej_snap = C_pl  # a rejection carries the commit before the fast-forward
    # The voter-side maybe_commit_by_vote off the request's commit (leaders
    # skip it).
    vff = (
        rej
        & (St_pl != ROLE_LEADER)
        & (c_t[None, :] > C_pl)
        & (c_t[None, :] <= agree_t)
    )
    V_pl = torch.where(grant, t_all[None, :], V_pl)
    EE_pl = torch.where(grant, 0, EE_pl)
    C_pl = torch.where(vff, c_t[None, :], C_pl)

    # ---- hop 4: the responses in voter order with the scalar win/loss
    # cutoffs and the candidate-side commit fast-forward; the order is the
    # result, so the loop stays sequential.
    n_i, n_o, q_i, q_o = _half_quorums(st)
    vm_t = torch.where(is_tgt, st.voter_mask, False).sum(0, dtype=I32)
    om_t = torch.where(is_tgt, st.outgoing_mask, False).sum(0, dtype=I32)
    cnt_i = torch.where(cg, vm_t, 0)  # the self-vote
    cnt_o = torch.where(cg, om_t, 0)
    rec_i, rec_o = cnt_i, cnt_o
    ff = torch.zeros((G,), dtype=I32, device=dev)
    del_g = grant & E_to_t
    del_r = rej & E_to_t
    for v in range(P):
        won_before, lost_before = _decided(
            cnt_i, cnt_o, rec_i, rec_o, (n_i, n_o, q_i, q_o)
        )
        ok = del_r[v] & ~won_before & ~lost_before & (rej_snap[v] <= agree_t[v])
        ff = torch.where(ok, torch.maximum(ff, rej_snap[v]), ff)
        resp_v = del_g[v] | del_r[v]
        rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
        rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
        cnt_i = cnt_i + (del_g[v] & st.voter_mask[v]).to(I32)
        cnt_o = cnt_o + (del_g[v] & st.outgoing_mask[v]).to(I32)
    won_end, lost_end = _decided(cnt_i, cnt_o, rec_i, rec_o, (n_i, n_o, q_i, q_o))
    won_t = cg & won_end
    lost_t = cg & ~won_t & lost_end
    C_pl = torch.where(
        is_tgt & cg[None, :], torch.maximum(C_pl, ff[None, :]), C_pl
    )

    # ---- hop 5: the winner's become_leader, noop append, broadcast,
    # quorum commit and commit re-broadcast; a decided loser steps down at
    # t_star (a same-term reset keeps its self-vote).
    win_mask = is_tgt & won_t[None, :]
    lose_mask = is_tgt & lost_t[None, :]
    St_pl = torch.where(win_mask, ROLE_LEADER, St_pl)
    Ld_pl = torch.where(win_mask, self_id, Ld_pl)
    EE_pl = torch.where(win_mask | lose_mask, 0, EE_pl)
    HB_pl = torch.where(win_mask | lose_mask, 0, HB_pl)
    St_pl = torch.where(lose_mask, ROLE_FOLLOWER, St_pl)
    Ld_pl = torch.where(lose_mask, 0, Ld_pl)
    LI_pl = LI_pl + win_mask.to(I32)  # the noop entry
    LT_pl = torch.where(win_mask, t_star[None, :], LT_pl)
    TS_pl = torch.where(win_mask, LI_pl, st.term_start_index)
    matched_pl = torch.where(win_mask[:, None, :], 0, matched_pl)
    # The noop broadcast carries the winner's commit before its quorum
    # commit.
    c_t_bcast = torch.where(is_tgt, C_pl, 0).sum(0, dtype=I32)
    noop_last = torch.where(win_mask, LI_pl, 0).sum(0, dtype=I32)
    noop_prev = noop_last - 1
    del_nb = (
        won_t[None, :] & member & ~is_tgt & E_from_t
        & (T_pl <= t_star[None, :])
    )
    # The probe gate: the noop append's prev entry must match, or a live
    # reverse link lets the reject/retry chain converge.
    nb_ok = del_nb & ((agree_t >= noop_prev[None, :]) | E_to_t)
    nb_bump = nb_ok & (T_pl < t_star[None, :])
    T_pl = torch.where(nb_ok, t_star[None, :], T_pl)
    St_pl = torch.where(nb_ok, ROLE_FOLLOWER, St_pl)
    V_pl = torch.where(nb_bump, 0, V_pl)
    Ld_pl = torch.where(nb_ok, t_all[None, :], Ld_pl)
    EE_pl = torch.where(nb_ok, 0, EE_pl)
    HB_pl = torch.where(nb_bump, 0, HB_pl)
    RT_pl = torch.where(nb_bump, draw(T_pl), RT_pl)
    LI_pl = torch.where(nb_ok, noop_last[None, :], LI_pl)
    LT_pl = torch.where(nb_ok, t_star[None, :], LT_pl)
    C_pl = torch.where(nb_ok, torch.maximum(C_pl, c_t_bcast[None, :]), C_pl)
    in_nb = nb_ok | win_mask
    agree_pl = _merge_agree(agree_pl, in_nb, noop_last, agree_t)
    ack_nb = nb_ok & E_to_t
    acked_m = ack_nb | win_mask  # the winner's own persisted noop
    matched_pl = torch.where(
        is_tgt[:, None, :] & acked_m[None, :, :] & won_t[None, None, :],
        noop_last[None, None, :],
        matched_pl,
    )
    if RA is not None:
        # become_leader's tracker reset (a self-only row), then the noop
        # acks mark the responders recently active.
        win_row = is_tgt[:, None, :] & won_t[None, None, :]
        RA = torch.where(win_row, eye, RA)
        RA = RA | (win_row & ack_nb[None, :, :])
    row_t = _weighted_row(matched_pl, is_tgt.to(I32))  # [P, G]
    mci = torch.minimum(
        _quorum_index(row_t, st.voter_mask),
        _quorum_index(row_t, st.outgoing_mask),
    )
    commit_ok = won_t & (mci >= noop_last) & (mci < kernels.INF)
    c_t_new = torch.where(commit_ok, torch.maximum(c_t_bcast, mci), c_t_bcast)
    C_pl = torch.where(is_tgt & won_t[None, :], c_t_new[None, :], C_pl)
    # The commit advance's re-broadcast reaches only the members whose
    # noop ack arrived (a lost ack leaves the fresh probe paused).
    C_pl = torch.where(ack_nb, torch.maximum(C_pl, c_t_new[None, :]), C_pl)

    # The reset-abort invariant: a lead_transferee survives only while its
    # owner keeps leading.
    T = torch.where(St_pl == ROLE_LEADER, T, 0)
    out = st._replace(
        term=T_pl,
        state=St_pl,
        vote=V_pl,
        leader_id=Ld_pl,
        election_elapsed=EE_pl,
        heartbeat_elapsed=HB_pl,
        randomized_timeout=RT_pl,
        last_index=LI_pl,
        last_term=LT_pl,
        commit=C_pl,
        matched=matched_pl,
        term_start_index=TS_pl,
        agree=agree_pl,
        recent_active=RA,
        transferee=T,
    )
    return out, cg, won_t


@profiling.phased
def step(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    group_ids=None,
    counters=None,
    health=None,
    link=None,
    reconfig_propose=None,
    transfer_propose=None,
    campaign_kick=None,
    read_propose=None,
    blackbox=None,
):
    """One lockstep protocol round for every group.  crashed: bool[P, G]
    peers isolated this round (they keep ticking, exchange no messages);
    append_n: int32[G] entries proposed at each group's leader; link:
    optional bool[P, P, G] directed reachability plane, which routes the
    round through `_linked_step`.  A damped config (check_quorum or
    pre_vote) always runs `_damped_linked_step`, under an all-up plane
    when `link` is None.  group_ids: optional int[G] GLOBAL group ids when
    `st` is a gathered sub-batch (cfg.n_groups is then the sub-batch
    width): they key the timeout draws, so each group's stream is the one
    it has in the whole batch.

    counters: optional int32[N_COUNTERS] event accumulator; health:
    optional HealthState.  reconfig_propose: optional bool[G], the groups
    whose pending conf-change op proposes its entry at the acting leader
    this round; the caller adds the +1 entry to `append_n`, and the step
    reports where the entry landed as a ReconfigProposal (owner 0 where no
    alive leader acted, so the op retries).  read_propose: optional int32[G]
    client-read commands (READ_* modes), evaluated by `_read_phase` on the
    round-entry state and reported as a ReadReceipt; the round itself is
    unchanged by them.

    transfer_propose: optional int32[G] MsgTransferLeader commands (the
    1-based target, 0 none), which need the transferee plane
    (SimConfig(transfer=True)).  With that plane every round first runs the
    transfer pump `_transfer_phase` on the round-entry state (after the
    read probe), and the round proper runs on its result; the counters and
    health extras keep the round-entry baseline, the transfer campaign and
    win join CTR_CAMPAIGNS and CTR_ELECTIONS_WON, and the health fold reads
    the winners off the end-of-round state.  A transfer pending at the
    acting leader drops the round's appends and conf entry (the proposal's
    owner is 0 then), the transfer clock expiring at the leader's
    election-timeout boundary aborts it, and only standing leaders keep
    their transferee.  campaign_kick: optional bool[P, G], the autopilot's
    MsgHup: a kicked promotable non-leader campaigns at tick time.

    blackbox: optional BlackboxState.  The round's per-group record (max
    role, acting leader, max term, max commit) folds into its ring on the
    round-exit state (kernels.blackbox_fold); the step runs no safety
    audit, so the fired-slot bits fold as zero (a caller auditing between
    rounds stamps them with kernels.blackbox_mark, and the runners fold
    bits and record in one call instead).

    Returns the next SimState alone when no extra is given, else
    (SimState, counters', health', blackbox', proposal, receipt) with the
    given ones in that order, as the reference's extras."""
    if transfer_propose is not None and st.transferee is None:
        raise ValueError(
            "step(transfer_propose=) needs the lead_transferee plane — "
            "construct the sim with SimConfig(transfer=True) (init_state "
            "creates it)"
        )
    if cfg.lease_read and not cfg.check_quorum:
        # Config.validate's rule: without the check-quorum boundary
        # deposal a lease proves nothing.
        raise ValueError(
            "SimConfig(lease_read=True) requires check_quorum=True "
            "(reference: Config.validate — read_only_option == LeaseBased "
            "requires check_quorum); undamped sims serve reads through "
            "the ReadIndex quorum round only"
        )
    profiling.phases()("general.round")
    node_key = _node_key(cfg, st.term.device, group_ids)
    damped = cfg.check_quorum or cfg.pre_vote
    if damped and link is None:
        link = torch.ones(
            (cfg.n_peers, cfg.n_peers, cfg.n_groups), dtype=torch.bool,
            device=st.term.device,
        )
    # The client-read phase: a probe of the round-entry state.
    receipt = (
        None if read_propose is None
        else _read_phase(cfg, st, crashed, read_propose, link)
    )
    # The transfer pump runs before the ticks, on the round-entry state.
    st_in = st
    transfer_facts = None
    if st.transferee is not None:
        st, t_campaigned, t_won = _transfer_phase(
            cfg, st, crashed, transfer_propose, link, node_key
        )
        transfer_facts = (t_campaigned, t_won)
    if damped:
        out, facts = _damped_linked_step(
            cfg, st, crashed, append_n, link, node_key, campaign_kick
        )
    elif link is not None:
        out, facts = _linked_step(
            cfg, st, crashed, append_n, link, node_key, campaign_kick
        )
    else:
        out, facts = _plain_step(cfg, st, crashed, append_n, node_key, campaign_kick)
    with profiling.annotate("general.extras"):
        extras = _extras(
            cfg, st_in, out, crashed, facts, counters, health, transfer_facts
        )
    if blackbox is not None:
        no_viol = torch.zeros(
            (kernels.N_SAFETY, cfg.n_groups), dtype=torch.bool,
            device=out.term.device,
        )
        extras += (BlackboxState(*kernels.blackbox_fold(
            *blackbox, out.state, out.term, out.commit, crashed, no_viol
        )),)
    if reconfig_propose is not None:
        has_leader, first_l, lead_last, lead_term = facts.lead
        prop = has_leader & reconfig_propose
        if facts.blocked is not None:
            # A pending transfer dropped the conf entry with the rest of
            # the batch: owner 0 makes the op retry.
            prop = prop & ~facts.blocked
        extras += (ReconfigProposal(
            owner=torch.where(prop, first_l + 1, 0),
            index=torch.where(prop, lead_last, 0),
            term=torch.where(prop, lead_term, 0),
        ),)
    if receipt is not None:
        extras += (receipt,)
    return (out,) + extras if extras else out


def _lead_commit(st: SimState, acting: torch.Tensor):
    """(servable bool[G], lead_commit int32[G]) of a read at the acting
    leader `acting` (bool[P, G]): whether it exists and has committed in
    its own term, and its commit index."""
    lead_commit = torch.where(acting, st.commit, 0).sum(0, dtype=I32)
    lead_ts = torch.where(acting, st.term_start_index, 0).sum(0, dtype=I32)
    return acting.any(0) & (lead_commit >= lead_ts), lead_commit


def read_index(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    link: Optional[torch.Tensor] = None,  # bool[P, P, G]
) -> torch.Tensor:
    """The batched linearizable ReadIndex barrier, Safe mode (read_only.rs
    and raft.rs step_leader's MsgReadIndex arm with
    handle_heartbeat_response's ack quorum): per group, the index a read
    issued at the acting leader at this round boundary returns, or -1 when
    it cannot complete: no alive leader, no commit in the leader's own term
    yet, or no ack quorum (alive members at a term <= the leader's ack the
    ctx heartbeat; joint configs need both majorities, at least one other
    member must respond, and a singleton group answers at once).  With
    `link`, an ack needs the leader -> member link and the member -> leader
    link.  A pure probe; int32[G]."""
    is_lead = (st.state == ROLE_LEADER) & ~crashed
    lead_term = torch.where(is_lead, st.term, -1).amax(0)
    acting = is_lead & (st.term == lead_term[None, :])
    servable, lead_commit = _lead_commit(st, acting)
    member = st.voter_mask | st.outgoing_mask | st.learner_mask
    n_i = st.voter_mask.sum(0, dtype=I32)
    n_o = st.outgoing_mask.sum(0, dtype=I32)
    singleton = (n_i == 1) & (n_o == 0)
    acker = (~crashed & member & (st.term <= lead_term[None, :])) | acting
    if link is not None:
        reach = (link & acting[:, None, :]).any(0)  # leader -> member
        ret = (link & acting[None, :, :]).any(1)  # member -> leader
        acker = (acker & reach & ret) | acting

    def half_quorum(mask):
        n = mask.sum(0, dtype=I32)
        return ((acker & mask).sum(0, dtype=I32) >= n // 2 + 1) | (n == 0)

    quorum = half_quorum(st.voter_mask) & half_quorum(st.outgoing_mask)
    # The ack quorum is only evaluated on a response, so a joint config
    # whose quorum is the leader alone hangs until some other member acks.
    any_other = (acker & ~acting).any(0)
    ok = servable & (singleton | (quorum & any_other))
    return torch.where(ok, lead_commit, -1)


def _read_quorum_damped(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    link: Optional[torch.Tensor],  # bool[P, P, G]
) -> torch.Tensor:
    """The Safe-mode ReadIndex barrier under damping: read_index's, but a
    ctx heartbeat reaching a higher-term member draws a deposing nudge
    (check_quorum/pre-vote's low-term arm), and become_follower wipes the
    pending read, so the read completes only if a quorum of acks lands
    strictly before the first deposing nudge in the response stream
    (peer-id order, the harness pump's).  The ack quorum is evaluated per
    processed ack, which gives the joint self-quorum hang and the
    one-responder rule.  A pure probe; int32[G] (-1 = not served)."""
    G, P = cfg.n_groups, cfg.n_peers
    dev = st.term.device
    alive = ~crashed
    member = st.voter_mask | st.outgoing_mask | st.learner_mask
    is_lead = (st.state == ROLE_LEADER) & alive
    lead_term = torch.where(is_lead, st.term, -1).amax(0)
    lead_id = kernels.acting_leader_id(st.state, st.term, crashed)
    p_id = torch.arange(1, P + 1, dtype=I32, device=dev)[:, None]
    acting = p_id == lead_id[None, :]
    servable, lead_commit = _lead_commit(st, acting)
    n_i = st.voter_mask.sum(0, dtype=I32)
    n_o = st.outgoing_mask.sum(0, dtype=I32)
    singleton = (n_i == 1) & (n_o == 0)
    q_i, q_o = n_i // 2 + 1, n_o // 2 + 1
    off_diag = ~torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    E = alive[:, None, :] & alive[None, :, :] & off_diag
    if link is not None:
        E = E & link
    reach = (E & acting[:, None, :]).any(0)  # leader -> member
    ret = (E & acting[None, :, :]).any(1)  # member -> leader
    resp = member & reach & ret & ~acting  # a delivered response
    ack_v = resp & (st.term <= lead_term[None, :])
    ndg_v = resp & (st.term > lead_term[None, :])  # the deposing nudge
    # The leader's own ack (add_request seeds the acks with itself).
    cnt_i = (acting & st.voter_mask).sum(0, dtype=I32)
    cnt_o = (acting & st.outgoing_mask).sum(0, dtype=I32)
    served = torch.zeros((G,), dtype=torch.bool, device=dev)
    dead = torch.zeros((G,), dtype=torch.bool, device=dev)
    # Sequential in peer-id order: a nudge at position v deposes a leader
    # not yet served, and every later response is ignored.
    for v in range(P):
        dead = dead | (ndg_v[v] & ~served)
        a = ack_v[v] & ~dead
        cnt_i = cnt_i + (a & st.voter_mask[v]).to(I32)
        cnt_o = cnt_o + (a & st.outgoing_mask[v]).to(I32)
        quorum = ((cnt_i >= q_i) | (n_i == 0)) & ((cnt_o >= q_o) | (n_o == 0))
        served = served | (a & quorum)
    ok = servable & (singleton | served)
    return torch.where(ok, lead_commit, -1)


def _read_phase(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    read_propose: torch.Tensor,  # int32[G]
    link: Optional[torch.Tensor],  # bool[P, P, G]
) -> ReadReceipt:
    """The client-read phase of all three rounds, on the round-entry state:
    a READ_LEASE request serves locally where the lease gate passes
    (kernels.lease_read, with cfg.lease_read on), and otherwise degrades to
    the ReadIndex quorum round that a READ_SAFE request runs (read_index
    undamped, _read_quorum_damped under damping), link-aware."""
    want = read_propose > READ_NONE
    lease_want = read_propose == READ_LEASE
    _, lease_served, lease_idx = kernels.lease_read(
        st.state, st.term, st.leader_id, st.election_elapsed, st.commit,
        st.term_start_index, crashed, cfg.election_tick,
        cfg.check_quorum and cfg.lease_read, st.transferee,
        st.recent_active, st.voter_mask, st.outgoing_mask,
    )
    serve_l = lease_want & lease_served
    fallback = want & ~serve_l
    if cfg.check_quorum or cfg.pre_vote:
        ri = _read_quorum_damped(cfg, st, crashed, link)
    else:
        ri = read_index(cfg, st, crashed, link)
    index = torch.where(serve_l, lease_idx, torch.where(fallback, ri, -1))
    return ReadReceipt(index=index, lease=serve_l, degraded=lease_want & ~serve_l)


def _extras(cfg, st, out, crashed, facts: _RoundFacts, counters, health,
            transfer_facts=None):
    """The reference's counters and health folds of one round from the
    (pre, post) state pair and the round's facts: (counters',) and/or
    (health',), in that order, for the extras that are not None.
    `transfer_facts` is the transfer pump's (campaigned bool[G], won
    bool[G]) when the round ran it: they join the campaign and election
    counts, and the health fold then reads `won` off the end-of-round
    state."""
    extras = ()
    if counters is not None:
        counters = kernels.count_events(
            counters, facts.want_campaign, facts.beats, facts.won,
            out.commit - st.commit,
        )
        if facts.real_campaigns is not None:
            bump = torch.zeros_like(counters)
            bump[kernels.CTR_CAMPAIGNS] = facts.real_campaigns.sum(dtype=I32)
            counters = counters + bump
        if transfer_facts is not None:
            bump = torch.zeros_like(counters)
            bump[kernels.CTR_CAMPAIGNS] = transfer_facts[0].sum(dtype=I32)
            bump[kernels.CTR_ELECTIONS_WON] = transfer_facts[1].sum(dtype=I32)
            counters = counters + bump
        extras += (counters,)
    if health is not None:
        lead_end = out.state == ROLE_LEADER
        has_lead_end = (lead_end & ~crashed).any(0)
        commit_adv = out.commit.amax(0) > st.commit.amax(0)
        term_bump = out.term.amax(0) - st.term.amax(0)
        campaigned = facts.want_campaign.any(0)
        won = facts.won
        if facts.observed_won or transfer_facts is not None:
            won = (
                lead_end & ((st.state != ROLE_LEADER) | (out.term > st.term))
            ).any(0)
        planes, pos = kernels.update_health(
            health.planes, health.window_pos, cfg.health_window,
            has_lead_end, commit_adv, term_bump, campaigned & ~won,
        )
        extras += (HealthState(planes, pos),)
    return extras


@profiling.phased
def _plain_step(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    node_key: torch.Tensor,  # int64[P, G]
    campaign_kick: Optional[torch.Tensor] = None,  # bool[P, G]
):
    """The undamped round without a link plane (the reference's `step`
    body); returns (SimState, _RoundFacts).  `campaign_kick` and a
    transferee plane act as in `step`."""
    G, P = cfg.n_groups, cfg.n_peers
    dev = st.term.device
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)

    draw = functools.partial(_draw, node_key, lo, hi)

    ph = profiling.phases()
    # ---- Phase A: tick every peer (crashed peers tick too).
    ph("general.tick")
    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask
    ee, hb, want_campaign, want_heartbeat, want_cq = kernels.tick_kernel(
        st.state,
        st.election_elapsed,
        st.heartbeat_elapsed,
        st.randomized_timeout,
        promotable,
        cfg.election_tick,
        cfg.heartbeat_tick,
    )
    want_campaign, ee, transferee = _tick_actions(
        st, promotable, want_campaign, ee, want_cq, campaign_kick
    )

    # ---- Phase B: campaigners become candidates: term+1, vote self, redraw.
    ph("general.campaign")
    term = st.term + want_campaign.to(I32)
    state = torch.where(want_campaign, ROLE_CANDIDATE, st.state)
    vote = torch.where(want_campaign, self_id, st.vote)
    leader_id = torch.where(want_campaign, 0, st.leader_id)
    rt = torch.where(want_campaign, draw(term), st.randomized_timeout)

    # ---- Phase C: election resolution among alive requesters, behind the
    # reference's lax.cond(any(req)): graphs.cond, a host branch here and a
    # conditional node inside ClusterSim.run_compiled's CUDA graph; with
    # spmd=True the phase runs unconditionally, which is bit-identical
    # because every write in it is masked on this round's campaigners.
    ph("general.elect")
    req = want_campaign & alive

    def elect(term, state, vote, leader_id, ee, hb, rt, li, lt, matched, ts,
              commit):
        any_req = req.any(0)  # [G]
        t_star = torch.where(req, term, 0).amax(0)  # [G]

        # Deposed-leader heartbeat interleaving (see the reference).
        prev_leader = (state == ROLE_LEADER) & alive
        prev_has = prev_leader.any(0)
        prev_lt = torch.where(prev_leader, term, -1).amax(0)
        prev_acting = prev_leader & (term == prev_lt)
        prev_first = torch.where(prev_acting, p_idx, P).amin(0)
        prev_is_acting = (p_idx == prev_first) & prev_has
        beat = (want_heartbeat & prev_is_acting).any(0)
        deposed = prev_has & (t_star > prev_lt) & any_req
        first_req = torch.where(req, p_idx, P).amin(0)
        hb_first = prev_first < first_req
        prev_row = _weighted_row(matched, prev_is_acting.to(I32))  # [P, G]
        prev_commit = torch.where(prev_is_acting, commit, 0).amax(0)
        hb_val = torch.minimum(prev_row, prev_commit[None, :])
        apply_v = (
            deposed & beat & hb_first & alive & promotable
            & (term <= prev_lt) & ~prev_is_acting
        )
        apply_l = deposed & beat & alive & st.learner_mask & (term <= prev_lt)
        commit = torch.where(
            apply_v | apply_l, torch.maximum(commit, hb_val), commit
        )
        ee = torch.where(apply_l, 0, ee)
        leader_id = torch.where(apply_l, prev_first + 1, leader_id)
        lrn_bump = apply_l & (term < prev_lt)
        term = torch.where(lrn_bump, prev_lt, term)
        vote = torch.where(lrn_bump, 0, vote)
        rt = torch.where(lrn_bump, draw(term), rt)

        # A higher-term request makes any alive voter a follower at t_star.
        bump = alive & promotable & (term < t_star) & any_req
        term_c = torch.where(bump, t_star, term)
        state_c = torch.where(bump, ROLE_FOLLOWER, state)
        vote_c = torch.where(bump, 0, vote)
        leader_c = torch.where(bump, 0, leader_id)
        ee_c = torch.where(bump, 0, ee)
        hb_c = torch.where(bump, 0, hb)
        rt_c = torch.where(bump, draw(term_c), rt)

        cand = req & (term == t_star)  # [P, G]

        # Vote decision per alive voter v; axes [c, v, G].
        lt_c, li_c = lt[:, None, :], li[:, None, :]
        lt_v, li_v = lt[None, :, :], li[None, :, :]
        up_to_date = (lt_c > lt_v) | ((lt_c == lt_v) & (li_c >= li_v))
        elig = cand[:, None, :] & up_to_date

        c_idx = torch.arange(P, dtype=I32, device=dev)[:, None, None]
        first_elig = torch.where(elig, c_idx, P).amin(0)  # [v, G]
        responder = alive & promotable & (term_c == t_star) & any_req
        can_vote = (vote_c == 0) & responder
        grant_to = torch.where(can_vote & (first_elig < P), first_elig, -1)
        granted_v = (grant_to[None, :, :] == c_idx) & (grant_to[None, :, :] >= 0)

        def tally(mask):
            grants = (granted_v & mask[None, :, :]).sum(1, dtype=I32)
            votes_for = grants + (cand & mask).to(I32)
            n = mask.sum(0, dtype=I32)
            q = n // 2 + 1
            resp = (responder & mask).sum(0, dtype=I32)
            missing = n - resp
            won_h = (votes_for >= q) | (n == 0)
            lost_h = (votes_for + missing < q) & (n > 0)
            return won_h, lost_h

        won_i, lost_i = tally(st.voter_mask)
        won_o, lost_o = tally(st.outgoing_mask)
        won = cand & won_i & won_o
        lost = cand & (lost_i | lost_o)
        winner_exists = won.any(0)  # [G]

        # Commit fast-forward via vote traffic, in the scalar pump's order.
        n_i = st.voter_mask.sum(0, dtype=I32)
        n_o = st.outgoing_mask.sum(0, dtype=I32)
        q_i = n_i // 2 + 1
        q_o = n_o // 2 + 1
        commit_run = commit
        cand_ff = torch.zeros_like(commit)
        for ci in range(P):
            c_active = cand[ci]
            c_req_commit = commit[ci]
            grants_ci = granted_v[ci]
            rej_ci = responder & ~grants_ci & (p_idx != ci) & c_active[None, :]
            agree_ci = st.agree[ci]
            cnt_i = (c_active & st.voter_mask[ci]).to(I32)
            cnt_o = (c_active & st.outgoing_mask[ci]).to(I32)
            rec_i, rec_o = cnt_i, cnt_o
            ff = torch.zeros((G,), dtype=I32, device=dev)
            for v in range(P):
                won_before = ((cnt_i >= q_i) | (n_i == 0)) & (
                    (cnt_o >= q_o) | (n_o == 0)
                )
                lost_before = (
                    (n_i > 0) & (cnt_i + (n_i - rec_i) < q_i)
                ) | ((n_o > 0) & (cnt_o + (n_o - rec_o) < q_o))
                snap = commit_run[v]
                ok = rej_ci[v] & ~won_before & ~lost_before & (snap <= agree_ci[v])
                ff = torch.where(ok, torch.maximum(ff, snap), ff)
                resp_v = grants_ci[v] | rej_ci[v]
                rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
                rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
                cnt_i = cnt_i + (grants_ci[v] & st.voter_mask[v]).to(I32)
                cnt_o = cnt_o + (grants_ci[v] & st.outgoing_mask[v]).to(I32)
            # The reference's .at[ci].set: a fresh plane with row ci replaced.
            cand_ff = cand_ff.clone()
            cand_ff[ci] = torch.maximum(cand_ff[ci], ff)
            vs_apply = (
                rej_ci
                & (state_c != ROLE_LEADER)
                & (c_req_commit[None, :] > commit_run)
                & (c_req_commit[None, :] <= agree_ci)
            )
            commit_run = torch.where(vs_apply, c_req_commit[None, :], commit_run)
        commit = torch.maximum(commit_run, cand_ff)

        vote_c = torch.where(grant_to >= 0, grant_to + 1, vote_c)
        ee_c = torch.where(grant_to >= 0, 0, ee_c)

        # Winner becomes leader and appends its noop; decided losers step down.
        li = torch.where(won, li + 1, li)
        lt = torch.where(won, t_star, lt)
        state_c = torch.where(won, ROLE_LEADER, state_c)
        leader_c = torch.where(won, self_id, leader_c)
        rt_c = torch.where(won, draw(term_c), rt_c)
        ee_c = torch.where(won, 0, ee_c)
        hb_c = torch.where(won, 0, hb_c)
        step_down = cand & ~won & (lost | (winner_exists & alive))
        state_c = torch.where(step_down, ROLE_FOLLOWER, state_c)
        rt_c = torch.where(step_down, draw(term_c), rt_c)
        ee_c = torch.where(step_down, 0, ee_c)

        matched = torch.where(won[:, None, :], 0, matched)
        ts = torch.where(won, li, ts)
        return (term_c, state_c, vote_c, leader_c, ee_c, hb_c, rt_c, li, lt,
                matched, ts, commit, winner_exists)

    def no_election(*planes):
        return planes + (torch.zeros((G,), dtype=torch.bool, device=dev),)

    planes = (term, state, vote, leader_id, ee, hb, rt, st.last_index,
              st.last_term, st.matched, st.term_start_index, st.commit)
    (term, state, vote, leader_id, ee, hb, rt, li, lt, matched, ts, commit,
     winner_exists) = (
        elect(*planes) if cfg.spmd
        else graphs.cond(req.any(), elect, no_election, planes)
    )
    new_last_index, new_last_term, term_start, commit_c = li, lt, ts, commit

    # ---- Phase C': a crashed campaigner that is the sole voter of both
    # config halves wins locally.
    def _half_solo(mask):
        n = mask.sum(0, dtype=I32)
        return (n[None, :] == 0) | ((n[None, :] == 1) & mask)

    solo_win = (
        want_campaign
        & crashed
        & _half_solo(st.voter_mask)
        & _half_solo(st.outgoing_mask)
    )
    state = torch.where(solo_win, ROLE_LEADER, state)
    leader_id = torch.where(solo_win, self_id, leader_id)
    new_last_index = new_last_index + solo_win.to(I32)
    new_last_term = torch.where(solo_win, term, new_last_term)
    term_start = torch.where(solo_win, new_last_index, term_start)
    matched = torch.where(solo_win[:, None, :], 0, matched)
    eye = torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    matched = torch.where(
        solo_win[:, None, :] & eye, new_last_index[:, None, :], matched
    )
    commit_c = torch.where(solo_win, new_last_index, commit_c)
    hb = torch.where(solo_win, 0, hb)

    # ---- Phase D: replication round for groups with an alive leader.
    ph("general.replicate")
    is_leader = (state == ROLE_LEADER) & alive
    has_leader = is_leader.any(0)
    lead_term = torch.where(is_leader, term, -1).amax(0)
    is_acting = is_leader & (term == lead_term)
    first_l = torch.where(is_acting, p_idx, P).amin(0)
    is_acting_leader = (p_idx == first_l) & has_leader

    n_app, blocked = _drop_proposals(
        torch.where(has_leader, append_n, 0), is_acting_leader, transferee
    )
    new_last_index = new_last_index + torch.where(is_acting_leader, n_app, 0)
    new_last_term = torch.where(is_acting_leader, lead_term, new_last_term)

    lead_last = torch.where(is_acting_leader, new_last_index, 0).amax(0)
    lead_last_term = torch.where(is_acting_leader, new_last_term, 0).amax(0)

    lead_beat = (want_heartbeat & is_acting_leader).any(0)
    sent = has_leader & (lead_beat | (n_app > 0) | winner_exists)

    sync = sent & alive & member & (term <= lead_term) & ~is_acting_leader
    term_bumped = sync & (term < lead_term)
    term_d = torch.where(sync, lead_term, term)
    state_d = torch.where(sync, ROLE_FOLLOWER, state)
    vote_d = torch.where(term_bumped, 0, vote)
    leader_d = torch.where(sync, first_l + 1, leader_id)
    ee = torch.where(sync, 0, ee)
    rt = torch.where(term_bumped, draw(term_d), rt)
    new_last_index = torch.where(sync, lead_last, new_last_index)
    new_last_term = torch.where(sync, lead_last_term, new_last_term)

    acting_f = is_acting_leader.to(I32)
    in_s = sync | is_acting_leader
    agree_lead_row = _weighted_row(st.agree, acting_f)  # [P, G]: agree[l, b]
    agree = _merge_agree(st.agree, in_s, lead_last, agree_lead_row)
    acting_row = _weighted_row(matched, acting_f)  # [P_t, G]
    acting_row = torch.where(sync | is_acting_leader, new_last_index, acting_row)
    matched = torch.where(
        is_acting_leader[:, None, :], acting_row[None, :, :], matched
    )
    ts_acting = _weighted_row(term_start, acting_f)  # [G]

    # Quorum commit over both majorities, gated on the leader's own term.
    mci = torch.minimum(
        _quorum_index(acting_row, st.voter_mask),
        _quorum_index(acting_row, st.outgoing_mask),
    )
    commit_ok = has_leader & (mci >= ts_acting) & (mci < kernels.INF)
    lead_commit_old = torch.where(is_acting_leader, commit_c, 0).amax(0)
    lead_commit = torch.where(
        commit_ok, torch.maximum(lead_commit_old, mci), lead_commit_old
    )
    commit = torch.where(is_acting_leader, lead_commit, commit_c)
    commit = torch.where(sync, torch.maximum(commit, lead_commit), commit)

    if transferee is not None:
        # Every become_* path runs reset(), which clears lead_transferee:
        # only standing leaders keep theirs.
        transferee = torch.where(state_d == ROLE_LEADER, transferee, 0)
    out = SimState(
        term=term_d,
        state=state_d,
        vote=vote_d,
        leader_id=leader_d,
        election_elapsed=ee,
        heartbeat_elapsed=hb,
        randomized_timeout=rt,
        last_index=new_last_index,
        last_term=new_last_term,
        commit=commit,
        matched=matched,
        term_start_index=term_start,
        agree=agree,
        voter_mask=st.voter_mask,
        outgoing_mask=st.outgoing_mask,
        learner_mask=st.learner_mask,
        transferee=transferee,
    )
    # A group wins at most one election a round, and the solo crashed
    # campaigner excludes the networked win: become_leader's count.
    return out, _RoundFacts(
        want_campaign, want_heartbeat, winner_exists | solo_win.any(0),
        lead=(has_leader, first_l, lead_last, lead_term), blocked=blocked,
    )


def _tick_actions(st, promotable, want_campaign, ee, want_cq, campaign_kick,
                  reset_clock=True):
    """The tick-time transfer and kick arms of all three rounds:
    (want_campaign', ee', transferee').  A kicked promotable non-leader
    campaigns this round (the autopilot's MsgHup, the RawNode::campaign
    admin call), its clock zeroed by become_candidate's reset when
    `reset_clock`; the transfer clock expiring at the leader's
    election-timeout boundary (`want_cq`) abandons a pending transfer
    (raft.rs:1051-1079)."""
    if campaign_kick is not None:
        kicked = campaign_kick & (st.state != ROLE_LEADER) & promotable
        want_campaign = want_campaign | kicked
        if reset_clock:
            ee = torch.where(kicked, 0, ee)
    transferee = st.transferee
    if transferee is not None:
        transferee = torch.where(want_cq, 0, transferee)
    return want_campaign, ee, transferee


def _drop_proposals(n_app, is_acting_leader, transferee):
    """ProposalDropped: a transfer pending at the acting leader drops the
    round's proposals (step_leader's lead_transferee gate).  Returns
    (n_app', blocked bool[G], or None without a transferee plane)."""
    if transferee is None:
        return n_app, None
    blocked = (is_acting_leader & (transferee > 0)).any(0)
    return torch.where(blocked, 0, n_app), blocked


def _merge_agree(agree, in_set, value, lead_row):
    """One wholesale-adoption agreement event: pairs inside `in_set` agree
    to `value` [G]; a pair with one side inside inherits `lead_row` [P, G]
    (the sender's agreement row) at the other side; the rest keep
    `agree`."""
    return torch.where(
        in_set[:, None, :] & in_set[None, :, :],
        value[None, None, :],
        torch.where(
            in_set[:, None, :],
            lead_row[None, :, :],
            torch.where(in_set[None, :, :], lead_row[:, None, :], agree),
        ),
    )


def _set_row(plane: torch.Tensor, sid: int, row: torch.Tensor) -> torch.Tensor:
    """A fresh plane equal to `plane` with row `sid` replaced by `row`."""
    out = plane.clone()
    out[sid] = row
    return out


def _half_quorums(st: SimState):
    """(n_i, n_o, q_i, q_o): each config half's voter count and quorum."""
    n_i = st.voter_mask.sum(0, dtype=I32)
    n_o = st.outgoing_mask.sum(0, dtype=I32)
    return n_i, n_o, kernels.majority_of(n_i), kernels.majority_of(n_o)


def _decided(cnt_i, cnt_o, rec_i, rec_o, quorums):
    """(won, lost) of a tally so far: both halves granted a quorum (or are
    empty), or some half can no longer reach one."""
    n_i, n_o, q_i, q_o = quorums
    won = ((cnt_i >= q_i) | (n_i == 0)) & ((cnt_o >= q_o) | (n_o == 0))
    lost = ((n_i > 0) & (cnt_i + (n_i - rec_i) < q_i)) | (
        (n_o > 0) & (cnt_o + (n_o - rec_o) < q_o)
    )
    return won, lost


def _real_tally(st, C, active, grants, resps, snaps, Erev, agree):
    """The per-candidate vote tally in voter order with the scalar win/loss
    cutoffs (the reference's wave-2 machinery, `_real_tally` in its damped
    round).  active bool[P, G]: candidates still campaigning; grants[s],
    resps[s], snaps[s] [P_v, G]: s's grants, responses and reject-time
    commit snapshots; `agree` [P, P, G] the agreement rows the commit
    fast-forward checks.  Returns (C', won, lost)."""
    P = active.shape[0]
    quorums = _half_quorums(st)
    won_rows, lost_rows = [], []
    for sid in range(P):
        act = active[sid]
        del_g = grants[sid] & Erev[sid]
        del_r = (resps[sid] & ~grants[sid]) & Erev[sid]
        cnt_i = (act & st.voter_mask[sid]).to(I32)  # self-vote
        cnt_o = (act & st.outgoing_mask[sid]).to(I32)
        rec_i, rec_o = cnt_i, cnt_o
        ff = torch.zeros_like(C[sid])
        for v in range(P):
            won_before, lost_before = _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)
            snap_v = snaps[sid][v]
            ok = del_r[v] & ~won_before & ~lost_before & (snap_v <= agree[sid][v])
            ff = torch.where(ok, torch.maximum(ff, snap_v), ff)
            resp_v = del_g[v] | del_r[v]
            rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
            rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
            cnt_i = cnt_i + (del_g[v] & st.voter_mask[v]).to(I32)
            cnt_o = cnt_o + (del_g[v] & st.outgoing_mask[v]).to(I32)
        won_ci, lost_ci = _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)
        won_ci = act & won_ci
        C = _set_row(C, sid, torch.maximum(C[sid], ff))
        won_rows.append(won_ci)
        lost_rows.append(act & ~won_ci & lost_ci)
    return C, torch.stack(won_rows), torch.stack(lost_rows)


def _cut_before(eff: torch.Tensor, dim: int) -> torch.Tensor:
    """True strictly after the first True along `dim`: the response-stream
    cutoff, where a deposed sender ignores everything later in its
    stream.  The cumsum is pinned to int32 (it widens to int64 otherwise)."""
    e = eff.to(I32)
    return (torch.cumsum(e, dim=dim, dtype=I32) - e) > 0


@profiling.phased
def _linked_step(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    link: torch.Tensor,  # bool[P, P, G]
    node_key: torch.Tensor,  # int64[P, G]
    campaign_kick: Optional[torch.Tensor] = None,  # bool[P, G]
):
    """The link-gated protocol round behind `step(..., link=)`: the
    reference's `_linked_step` (sim.py:1792-2428); returns (SimState,
    _RoundFacts) for `step`'s extras.

    Every exchange is gated per directed link: the delivery plane is
    `E[src, dst, g] = link & alive(src) & alive(dst)`, self edges excluded.
    The phases replay the scalar pump's waves: wave 1 (vote requests and
    heartbeats, per receiver in sender order), wave 2 (responses over the
    reverse links, per-candidate tallies in voter order with the win/loss
    cutoffs), the append passes with their stage-A and stage-B quorum
    commits and the commit re-broadcast, then the round's append workload
    at the acting leader.  Each of the reference's `lax.scan`s over
    senders is a Python loop over `s` in the same order; the receive order
    is what makes the result bit-identical."""
    G, P = cfg.n_groups, cfg.n_peers
    dev = st.term.device
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    eye = torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    E = link & alive[:, None, :] & alive[None, :, :] & ~eye
    Erev = E.transpose(0, 1)  # Erev[s, v, g]: v -> s delivery
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)

    draw = functools.partial(_draw, node_key, lo, hi)

    ph = profiling.phases()
    ph("general.tick")
    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask
    ee, hb, want_campaign, want_heartbeat, want_cq = kernels.tick_kernel(
        st.state,
        st.election_elapsed,
        st.heartbeat_elapsed,
        st.randomized_timeout,
        promotable,
        cfg.election_tick,
        cfg.heartbeat_tick,
    )
    want_campaign, ee, transferee = _tick_actions(
        st, promotable, want_campaign, ee, want_cq, campaign_kick
    )

    # Campaign side effects are local; isolation cuts the network, never
    # the clock.
    ph("general.campaign")
    term = st.term + want_campaign.to(I32)
    state = torch.where(want_campaign, ROLE_CANDIDATE, st.state)
    vote = torch.where(want_campaign, self_id, st.vote)
    leader_id = torch.where(want_campaign, 0, st.leader_id)
    rt = torch.where(want_campaign, draw(term), st.randomized_timeout)
    req = want_campaign
    hb_send = want_heartbeat

    # ---- wave 1: tick-queued traffic, per receiver in sender order.
    # Candidate payloads are the pre-round cursors.
    ph("general.wave1")
    T, V, Ld, St, EE, HB, RT, C = (
        term, vote, leader_id, state, ee, hb, rt, st.commit
    )
    grants, resps, rej_snap, hb_accs = [], [], [], []
    for sid in range(P):
        d = E[sid]
        t_s = term[sid][None, :]
        # Heartbeat from s, queued at tick time: delivered even if s is
        # deposed later this round.
        h_del = d & hb_send[sid][None, :] & member
        h_bump = h_del & (t_s > T)
        h_acc = h_del & (t_s >= T)  # lower-term heartbeats: silent ignore
        T = torch.where(h_bump, t_s, T)
        V = torch.where(h_bump, 0, V)
        St = torch.where(h_acc, ROLE_FOLLOWER, St)
        Ld = torch.where(h_acc, sid + 1, Ld)
        EE = torch.where(h_acc, 0, EE)
        HB = torch.where(h_bump, 0, HB)
        RT = torch.where(h_bump, draw(T), RT)
        hb_val = torch.minimum(st.matched[sid], st.commit[sid][None, :])
        C = torch.where(h_acc, torch.maximum(C, hb_val), C)
        # Vote request from s, with the can_vote leader_id gate.
        r_del = d & req[sid][None, :] & promotable
        r_bump = r_del & (t_s > T)
        T = torch.where(r_bump, t_s, T)
        V = torch.where(r_bump, 0, V)
        Ld = torch.where(r_bump, 0, Ld)
        St = torch.where(r_bump, ROLE_FOLLOWER, St)
        EE = torch.where(r_bump, 0, EE)
        HB = torch.where(r_bump, 0, HB)
        RT = torch.where(r_bump, draw(T), RT)
        at = r_del & (T == t_s)  # higher-term receivers silently ignore
        lt_s = st.last_term[sid][None, :]
        up = (lt_s > st.last_term) | (
            (lt_s == st.last_term) & (st.last_index[sid][None, :] >= st.last_index)
        )
        g = at & (V == 0) & (Ld == 0) & up
        rej = at & ~g
        snap = C  # reject responses snapshot commit before the fast-forward
        c_s = st.commit[sid][None, :]
        # Voter-side maybe_commit_by_vote off the request's commit info.
        vff = rej & (St != ROLE_LEADER) & (c_s > C) & (c_s <= st.agree[sid])
        V = torch.where(g, sid + 1, V)
        EE = torch.where(g, 0, EE)
        C = torch.where(vff, c_s, C)
        grants.append(g)
        resps.append(at)
        rej_snap.append(snap)
        hb_accs.append(h_acc)

    # ---- wave 2: responses over the reverse links; each candidate tallies
    # in voter order with the scalar cutoffs.
    ph("general.wave2")
    C, won, lost = _real_tally(
        st, C, req & (St == ROLE_CANDIDATE), grants, resps, rej_snap, Erev,
        st.agree,
    )

    # Winners become leaders and append their noop; losers of a decided
    # election step down.
    ph("general.elect")
    li2 = st.last_index + won.to(I32)
    lt2 = torch.where(won, term, st.last_term)
    TS = torch.where(won, li2, st.term_start_index)
    St = torch.where(won, ROLE_LEADER, St)
    Ld = torch.where(won, self_id, Ld)
    RT = torch.where(won | lost, draw(T), RT)
    EE = torch.where(won | lost, 0, EE)
    HB = torch.where(won, 0, HB)
    St = torch.where(lost, ROLE_FOLLOWER, St)
    matched3 = torch.where(won[:, None, :], 0, st.matched)
    matched3 = torch.where(won[:, None, :] & eye, li2[:, None, :], matched3)

    # ---- waves 3+: append deliveries.  Pass 1 = winner noop broadcasts
    # plus heartbeat-triggered catch-ups (the heartbeat response needs the
    # reverse link).  A delivered, term-accepted append resets the
    # receiver's timer and leader; the log is adopted only on a probe match
    # (`agree[s, v] >= prev`) or a live reverse link (the retry chain).
    ph("general.wave3")
    agree_run = st.agree
    St2 = St  # send-time snapshots
    C_send = C
    LI, LT = li2, lt2
    resumed_rows = []
    for sid in range(P):
        e_s, erev_s = E[sid], Erev[sid]
        t_s = term[sid][None, :]
        li2_s = li2[sid][None, :]
        res = hb_accs[sid] & erev_s  # pr.resume() at the leader
        cu = (
            res
            & (st.matched[sid] < st.last_index[sid][None, :])
            & (St2[sid] == ROLE_LEADER)[None, :]
        )
        dmask = e_s & member & (won[sid][None, :] | cu)
        msg = dmask & (t_s >= T)
        agree_s = agree_run[sid]
        # The winner's noop probe carries prev = its pre-noop cursor.
        adopt = msg & (cu | (agree_s >= st.last_index[sid][None, :]) | erev_s)
        bump = msg & (t_s > T)
        T = torch.where(msg, t_s, T)
        V = torch.where(bump, 0, V)
        St = torch.where(msg, ROLE_FOLLOWER, St)
        Ld = torch.where(msg, sid + 1, Ld)
        EE = torch.where(msg, 0, EE)
        RT = torch.where(bump, draw(T), RT)
        C = torch.where(adopt, torch.maximum(C, C_send[sid][None, :]), C)
        ack = adopt & erev_s
        m3_s = matched3[sid]
        matched3 = _set_row(
            matched3, sid, torch.where(ack, torch.maximum(m3_s, li2_s), m3_s)
        )
        in_s = adopt | ((p_idx == sid) & adopt.any(0)[None, :])
        agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_s)
        LI = torch.where(adopt, li2_s, LI)
        LT = torch.where(adopt, lt2[sid][None, :], LT)
        resumed_rows.append(res)
    resumed = torch.stack(resumed_rows)

    def quorum(row):
        return torch.minimum(
            _quorum_index(row, st.voter_mask),
            _quorum_index(row, st.outgoing_mask),
        )

    # Stage-A quorum commit per leader off the fresh acks (the term gate is
    # maybe_commit's own-term check).
    adv_rows = []
    for sid in range(P):
        mci = quorum(matched3[sid])
        c_s = C[sid]
        ok = (St[sid] == ROLE_LEADER) & (mci >= TS[sid]) & (mci < kernels.INF)
        c_new = torch.where(ok, torch.maximum(c_s, mci), c_s)
        C = _set_row(C, sid, c_new)
        adv_rows.append(c_new > c_s)

    # Pass 2: a commit advance re-broadcasts appends to every member whose
    # Progress can still send (acked since the election, or resumed this
    # round), with prev = the leader's current last.
    for sid in range(P):
        e_s, erev_s = E[sid], Erev[sid]
        t_s = term[sid][None, :]
        li2_s = li2[sid][None, :]
        m3_s = matched3[sid]
        dmask = e_s & member & adv_rows[sid][None, :] & ((m3_s > 0) | resumed[sid])
        msg = dmask & (t_s >= T)
        agree_s = agree_run[sid]
        adopt = msg & ((agree_s >= li2_s) | erev_s)
        bump = msg & (t_s > T)
        T = torch.where(msg, t_s, T)
        V = torch.where(bump, 0, V)
        St = torch.where(msg, ROLE_FOLLOWER, St)
        Ld = torch.where(msg, sid + 1, Ld)
        EE = torch.where(msg, 0, EE)
        RT = torch.where(bump, draw(T), RT)
        LI = torch.where(adopt, li2_s, LI)
        LT = torch.where(adopt, lt2[sid][None, :], LT)
        ack = adopt & erev_s
        matched3 = _set_row(
            matched3, sid, torch.where(ack, torch.maximum(m3_s, li2_s), m3_s)
        )
        in_s = adopt | ((p_idx == sid) & adopt.any(0)[None, :])
        agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_s)

    # Stage-B commit, then the post-advance propagation: a LEADER whose
    # commit rose past what its sends carried delivers the settled value to
    # sendable Progresses where the probe matches or the reverse link is up.
    for sid in range(P):
        mci = quorum(matched3[sid])
        c_s = C[sid]
        is_lead_s = St[sid] == ROLE_LEADER
        ok = is_lead_s & (mci >= TS[sid]) & (mci < kernels.INF)
        c_new = torch.where(ok, torch.maximum(c_s, mci), c_s)
        C = _set_row(C, sid, c_new)
        elig = (
            E[sid]
            & member
            & is_lead_s[None, :]
            & (term[sid][None, :] >= T)
            & ((matched3[sid] > 0) | resumed[sid])
            & ((agree_run[sid] >= li2[sid][None, :]) | Erev[sid])
            & (c_new > C_send[sid])[None, :]
        )
        C = torch.where(elig, torch.maximum(C, c_new[None, :]), C)

    # ---- the round's append workload at the acting leader, link-gated.
    ph("general.workload")
    is_leader = (St == ROLE_LEADER) & alive
    has_leader = is_leader.any(0)
    lead_term = torch.where(is_leader, T, -1).amax(0)
    is_acting = is_leader & (T == lead_term)
    first_l = torch.where(is_acting, p_idx, P).amin(0)
    is_acting_leader = (p_idx == first_l) & has_leader
    n_app, blocked = _drop_proposals(
        torch.where(has_leader, append_n, 0), is_acting_leader, transferee
    )
    sent_b = has_leader & (n_app > 0)
    lead_pre_last = torch.where(is_acting_leader, LI, 0).amax(0)
    LI = LI + torch.where(is_acting_leader, n_app, 0)
    LT = torch.where(is_acting_leader & (n_app > 0), lead_term, LT)
    lead_last = torch.where(is_acting_leader, LI, 0).amax(0)
    lead_last_term = torch.where(is_acting_leader, LT, 0).amax(0)
    reach_b = (E & is_acting_leader[:, None, :]).any(0)  # [P_v, G]
    ack_path = (E & is_acting_leader[None, :, :]).any(1)  # v -> l
    acting_f = is_acting_leader.to(I32)
    acting_row0 = _weighted_row(matched3, acting_f)
    resumed_act = (resumed & is_acting_leader[:, None, :]).any(0)
    agree_act = _weighted_row(agree_run, acting_f)
    # The proposal broadcast skips paused probes; delivered appends reset
    # timers either way, but the log is adopted only on a probe match or a
    # live reverse link.
    pr_ok = (acting_row0 > 0) | resumed_act
    sync_msg = (
        sent_b
        & reach_b
        & member
        & (T <= lead_term)
        & ~is_acting_leader
        & pr_ok
    )
    sync_b = sync_msg & ((agree_act >= lead_pre_last[None, :]) | ack_path)
    bump_b = sync_msg & (T < lead_term)
    T = torch.where(sync_msg, lead_term, T)
    St = torch.where(sync_msg, ROLE_FOLLOWER, St)
    V = torch.where(bump_b, 0, V)
    Ld = torch.where(sync_msg, first_l + 1, Ld)
    EE = torch.where(sync_msg, 0, EE)
    RT = torch.where(bump_b, draw(T), RT)
    LI = torch.where(sync_b, lead_last, LI)
    LT = torch.where(sync_b, lead_last_term, LT)
    in_sb = sync_b | (is_acting_leader & sent_b)
    agree_run = _merge_agree(agree_run, in_sb, lead_last, agree_act)
    acked_b = (sync_b & ack_path) | (is_acting_leader & sent_b)
    acting_row = torch.where(
        acked_b, torch.maximum(acting_row0, lead_last), acting_row0
    )
    matched3 = torch.where(
        is_acting_leader[:, None, :], acting_row[None, :, :], matched3
    )
    ts_acting = _weighted_row(TS, acting_f)
    mci_b = quorum(acting_row)
    commit_ok = sent_b & (mci_b >= ts_acting) & (mci_b < kernels.INF)
    lead_commit_old = torch.where(is_acting_leader, C, 0).amax(0)
    lead_commit = torch.where(
        commit_ok, torch.maximum(lead_commit_old, mci_b), lead_commit_old
    )
    C = torch.where(is_acting_leader, lead_commit, C)
    C = torch.where(sync_b, torch.maximum(C, lead_commit), C)

    if transferee is not None:
        # The reset-abort: only standing leaders keep their transferee.
        transferee = torch.where(St == ROLE_LEADER, transferee, 0)
    out = SimState(
        term=T,
        state=St,
        vote=V,
        leader_id=Ld,
        election_elapsed=EE,
        heartbeat_elapsed=HB,
        randomized_timeout=RT,
        last_index=LI,
        last_term=LT,
        commit=C,
        matched=matched3,
        term_start_index=TS,
        agree=agree_run,
        voter_mask=st.voter_mask,
        outgoing_mask=st.outgoing_mask,
        learner_mask=st.learner_mask,
        transferee=transferee,
    )
    return out, _RoundFacts(want_campaign, want_heartbeat, won.any(0),
                            lead=(has_leader, first_l, lead_last, lead_term),
                            blocked=blocked)


@profiling.phased
def _damped_linked_step(
    cfg: SimConfig,
    st: SimState,
    crashed: torch.Tensor,  # bool[P, G]
    append_n: torch.Tensor,  # int32[G]
    link: torch.Tensor,  # bool[P, P, G]
    node_key: torch.Tensor,  # int64[P, G]
    campaign_kick: Optional[torch.Tensor] = None,  # bool[P, G]
):
    """The damped (check-quorum / pre-vote) round: the reference's
    `_damped_linked_step` (sim.py:2451-3548); returns (SimState,
    _RoundFacts) for `step`'s extras.

    It extends `_linked_step`'s wave replay with the damping mechanisms,
    all in receipt order:

      tick      with check_quorum, each leader's election-timeout boundary
                reads and clears its recent_active row; without an active
                quorum it steps down and sends no heartbeat that round;
      lease     with check_quorum, a voter ignores a higher-term (pre-)vote
                request while leader_id != 0 and election_elapsed <
                election_tick at receipt (the running planes of the
                sender-ordered loops are receipt time);
      nudge     lower-term heartbeats and appends draw a response at the
                receiver's term, which deposes the stale sender in its
                response order: acks after the first such nudge are lost;
      pre-vote  campaigners probe at term + 1 without bumping anything;
                pre-winners run the real election two waves later, their
                vote requests interleaved with the catch-up appends.

    Acks, heartbeat responses and commit propagation set the owner's
    recent_active bits.  Each of the reference's `lax.scan`s over senders
    (and over voters inside a tally) is a Python loop in the same order."""
    if st.recent_active is None:
        raise ValueError(
            "damped step (SimConfig.check_quorum/pre_vote) needs the "
            "recent_active plane but the state has None; rebuild it with "
            "init_state(cfg)"
        )
    G, P = cfg.n_groups, cfg.n_peers
    cq, pv, et = cfg.check_quorum, cfg.pre_vote, cfg.election_tick
    dev = st.term.device
    self_id = torch.arange(P, dtype=I32, device=dev)[:, None] + 1  # [P, 1]
    p_idx = self_id - 1  # [P, 1]
    alive = ~crashed
    eye = torch.eye(P, dtype=torch.bool, device=dev)[:, :, None]
    E = link & alive[:, None, :] & alive[None, :, :] & ~eye
    Erev = E.transpose(0, 1)  # Erev[s, v, g]: v -> s delivery
    lo = torch.full((P, G), cfg.min_timeout, dtype=I32, device=dev)
    hi = torch.full((P, G), cfg.max_timeout, dtype=I32, device=dev)
    no = torch.zeros((P, G), dtype=torch.bool, device=dev)

    draw = functools.partial(_draw, node_key, lo, hi)

    ph = profiling.phases()
    ph("general.tick")
    promotable = st.voter_mask | st.outgoing_mask
    member = promotable | st.learner_mask
    ee, hb, want_campaign, want_heartbeat, want_cq = kernels.tick_kernel(
        st.state,
        st.election_elapsed,
        st.heartbeat_elapsed,
        st.randomized_timeout,
        promotable,
        cfg.election_tick,
        cfg.heartbeat_tick,
    )
    RA = st.recent_active
    state0, leader0 = st.state, st.leader_id

    # ---- the check-quorum boundary at tick time: read and clear the row;
    # without an active quorum the leader becomes a follower at its own
    # term and its heartbeat this round is suppressed.
    if cq:
        qa = kernels.check_quorum_active(RA, st.voter_mask, st.outgoing_mask)
        cq_dep = want_cq & ~qa
        RA = torch.where(want_cq[:, None, :], eye, RA)
        state0 = torch.where(cq_dep, ROLE_FOLLOWER, state0)
        leader0 = torch.where(cq_dep, 0, leader0)
        hb = torch.where(cq_dep, 0, hb)
        want_heartbeat = want_heartbeat & ~cq_dep
    # A kick goes through the ordinary damped machinery, a pre-vote probe
    # first with pre_vote, which keeps the clock (become_pre_candidate
    # touches only the role and leader_id); the transfer abort comes with
    # or without the check-quorum deposal.
    want_campaign, ee, transferee = _tick_actions(
        st, promotable, want_campaign, ee, want_cq, campaign_kick,
        reset_clock=not pv,
    )

    # ---- campaign local effects.  Real: term + 1, vote self, redraw.
    # Pre-vote: only the role and leader_id change; the request goes out
    # at term + 1.
    ph("general.campaign")
    if pv:
        term = st.term
        state = torch.where(want_campaign, ROLE_PRE_CANDIDATE, state0)
        vote = st.vote
        leader_id = torch.where(want_campaign, 0, leader0)
        rt = st.randomized_timeout
        req_term = term + want_campaign.to(I32)
    else:
        term = st.term + want_campaign.to(I32)
        state = torch.where(want_campaign, ROLE_CANDIDATE, state0)
        vote = torch.where(want_campaign, self_id, st.vote)
        leader_id = torch.where(want_campaign, 0, leader0)
        rt = torch.where(want_campaign, draw(term), st.randomized_timeout)
        req_term = term
    req = want_campaign
    hb_send = want_heartbeat
    quorums = _half_quorums(st)

    def in_lease(Ld, EE):
        return (Ld != 0) & (EE < et) if cq else no

    def up_to_date(sid, LT, LI):
        lt_s = st.last_term[sid][None, :]
        return (lt_s > LT) | ((lt_s == LT) & (st.last_index[sid][None, :] >= LI))

    # ---- wave 1: heartbeats and (pre-)vote requests, per receiver in
    # sender order, with lease ignores and low-term nudges.
    ph("general.wave1")
    T, V, Ld, St, EE, HB, RT, C = term, vote, leader_id, state, ee, hb, rt, st.commit
    grants, resps, snaps, resp_ts = [], [], [], []
    hb_accs, hb_ndg, hb_ndg_t = [], [], []
    for sid in range(P):
        d = E[sid]
        t_s = term[sid][None, :]
        h_del = d & hb_send[sid][None, :] & member
        h_bump = h_del & (t_s > T)
        h_acc = h_del & (t_s >= T)
        h_ndg = h_del & (t_s < T)  # the low-term nudge
        hb_ndg_t.append(torch.where(h_ndg, T, 0))
        T = torch.where(h_bump, t_s, T)
        V = torch.where(h_bump, 0, V)
        St = torch.where(h_acc, ROLE_FOLLOWER, St)
        Ld = torch.where(h_acc, sid + 1, Ld)
        EE = torch.where(h_acc, 0, EE)
        HB = torch.where(h_bump, 0, HB)
        RT = torch.where(h_bump, draw(T), RT)
        hb_val = torch.minimum(st.matched[sid], st.commit[sid][None, :])
        C = torch.where(h_acc, torch.maximum(C, hb_val), C)
        # (Pre-)vote request from s at its request term.
        rq = req_term[sid][None, :]
        c_s = st.commit[sid][None, :]
        r_del = d & req[sid][None, :] & promotable
        open_rq = r_del & ~(r_del & (rq > T) & in_lease(Ld, EE))
        up = up_to_date(sid, st.last_term, st.last_index)
        if pv:
            # No term bump, no vote record, no timer reset.
            at_hi = open_rq & (rq > T)
            at_eq = open_rq & (rq == T)
            g = (at_hi | (at_eq & ((V == sid + 1) | ((V == 0) & (Ld == 0))))) & up
            rej = (at_hi | at_eq) & ~g  # a reject with commit info
            snaps.append(torch.where(rej, C, 0))
            resps.append(g | rej | (open_rq & (rq < T)))
            resp_ts.append(torch.where(g, rq, T))
        else:
            bump = open_rq & (rq > T)
            T = torch.where(bump, rq, T)
            V = torch.where(bump, 0, V)
            Ld = torch.where(bump, 0, Ld)
            St = torch.where(bump, ROLE_FOLLOWER, St)
            EE = torch.where(bump, 0, EE)
            HB = torch.where(bump, 0, HB)
            RT = torch.where(bump, draw(T), RT)
            at = open_rq & (T == rq)
            g = at & (V == 0) & (Ld == 0) & up
            rej = at & ~g
            snaps.append(C)
            resps.append(at)
            V = torch.where(g, sid + 1, V)
            EE = torch.where(g, 0, EE)
        # Voter-side maybe_commit_by_vote off the request's commit info.
        vff = rej & (St != ROLE_LEADER) & (c_s > C) & (c_s <= st.agree[sid])
        C = torch.where(vff, c_s, C)
        grants.append(g)
        hb_accs.append(h_acc)
        hb_ndg.append(h_ndg)
    hb_accs, hb_ndg, hb_ndg_t = map(torch.stack, (hb_accs, hb_ndg, hb_ndg_t))

    # ---- wave 2a: heartbeat responses and nudges back at each leader, in
    # receiver order: the first nudge above the leader's term cuts off
    # every later response and deposes it at the largest nudge term.
    ph("general.wave2")
    eff_hn = hb_ndg & Erev & (hb_ndg_t > T[:, None, :])
    resumed2 = (
        hb_accs
        & Erev
        & ~_cut_before(eff_hn, 1)
        & ((T == term) & (St == ROLE_LEADER))[:, None, :]
    )
    RA = RA | resumed2
    cu = resumed2 & (st.matched < st.last_index[:, None, :])
    hdep_t = torch.where(eff_hn, hb_ndg_t, 0).amax(1)
    hdep = eff_hn.any(1)
    T = torch.where(hdep, torch.maximum(T, hdep_t), T)
    V = torch.where(hdep, 0, V)
    St = torch.where(hdep, ROLE_FOLLOWER, St)
    Ld = torch.where(hdep, 0, Ld)
    EE = torch.where(hdep, 0, EE)
    HB = torch.where(hdep, 0, HB)
    RT = torch.where(hdep, draw(T), RT)

    if not pv:
        # ---- wave 2b: the real tally, as in _linked_step.
        C, won, lost = _real_tally(
            st, C, req & (St == ROLE_CANDIDATE), grants, resps, snaps, Erev,
            st.agree,
        )
        real_req = no
        rqt2 = req_term
    else:
        # ---- wave 2b: the pre-vote tally, responses in voter order.  A
        # reject above the candidate's current term deposes it (chainable),
        # a reject at its pre-campaign term records a poll rejection, grants
        # count while undecided; on a quorum the pre-winner campaigns for
        # real (term + 1, vote self, timers reset), its vote requests queued
        # for wave 3.
        pre_active = req & (St == ROLE_PRE_CANDIDATE)
        won_rows = []
        for sid in range(P):
            act = pre_active[sid]
            del_g = grants[sid] & Erev[sid]
            del_r = (resps[sid] & ~grants[sid]) & Erev[sid]
            t0 = term[sid]
            cnt_i = (act & st.voter_mask[sid]).to(I32)
            cnt_o = (act & st.outgoing_mask[sid]).to(I32)
            rec_i, rec_o = cnt_i, cnt_o
            won_f = act & _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)[0]
            lost_f = dep_f = torch.zeros_like(act)
            cur_t = torch.where(won_f, t0 + 1, t0)
            ff = torch.zeros_like(t0)
            for v in range(P):
                rt_v, snap_v = resp_ts[sid][v], snaps[sid][v]
                dep_now = del_r[v] & (rt_v > cur_t)
                undecided = ~dep_f & ~won_f & ~lost_f
                rec_grant = del_g[v] & undecided
                rec_rej = del_r[v] & (rt_v == t0) & undecided
                ok = rec_rej & (snap_v <= st.agree[sid][v])
                ff = torch.where(ok, torch.maximum(ff, snap_v), ff)
                cnt_i = cnt_i + (rec_grant & st.voter_mask[v]).to(I32)
                cnt_o = cnt_o + (rec_grant & st.outgoing_mask[v]).to(I32)
                resp_v = rec_grant | rec_rej
                rec_i = rec_i + (resp_v & st.voter_mask[v]).to(I32)
                rec_o = rec_o + (resp_v & st.outgoing_mask[v]).to(I32)
                won_v, lost_v = _decided(cnt_i, cnt_o, rec_i, rec_o, quorums)
                won_now = rec_grant & won_v
                cur_t = torch.where(won_now, t0 + 1, cur_t)
                won_f = won_f | won_now
                lost_f = lost_f | (rec_rej & lost_v)
                dep_f = dep_f | dep_now
                cur_t = torch.where(dep_now, torch.maximum(cur_t, rt_v), cur_t)
            won_f, lost_f, dep_f = won_f & act, lost_f & act, dep_f & act
            # End-of-wave state of candidate row sid.
            C = _set_row(C, sid, torch.maximum(C[sid], ff))
            t_new = torch.where(act, cur_t, T[sid])
            win = won_f & ~dep_f
            v_new = torch.where(
                win, sid + 1, torch.where(dep_f & act & (cur_t != t0), 0, V[sid])
            )
            st_new = torch.where(
                win,
                ROLE_CANDIDATE,
                torch.where(dep_f | lost_f, ROLE_FOLLOWER, St[sid]),
            )
            settled = won_f | lost_f | dep_f
            rt_new = torch.where(
                won_f | dep_f,
                _draw(node_key[sid], lo[sid], hi[sid], t_new),
                RT[sid],
            )
            T = _set_row(T, sid, t_new)
            V = _set_row(V, sid, v_new)
            St = _set_row(St, sid, st_new)
            EE = _set_row(EE, sid, torch.where(settled, 0, EE[sid]))
            HB = _set_row(HB, sid, torch.where(settled, 0, HB[sid]))
            RT = _set_row(RT, sid, rt_new)
            won_rows.append(won_f)
        real_req = torch.stack(won_rows)  # broadcasts queued at win time
        rqt2 = term + 1

    # ---- after the real election (no pre-vote): winners become leaders
    # and append their noop; losers of a decided election step down.
    ph("general.elect")
    if not pv:
        li2 = st.last_index + won.to(I32)
        lt2 = torch.where(won, term, st.last_term)
        TS = torch.where(won, li2, st.term_start_index)
        St = torch.where(won, ROLE_LEADER, St)
        Ld = torch.where(won, self_id, Ld)
        RT = torch.where(won | lost, draw(T), RT)
        EE = torch.where(won | lost, 0, EE)
        HB = torch.where(won, 0, HB)
        St = torch.where(lost, ROLE_FOLLOWER, St)
        matched3 = torch.where(won[:, None, :], 0, st.matched)
        matched3 = torch.where(won[:, None, :] & eye, li2[:, None, :], matched3)
        RA = RA & ~won[:, None, :]
        noop_w3 = won
    else:
        li2, lt2 = st.last_index, st.last_term
        TS, matched3 = st.term_start_index, st.matched
        noop_w3 = won = no

    agree_run = st.agree
    LI, LT = li2, lt2
    C_send = C  # commit snapshots for the wave-3 sends

    def follow(msg, t, T, V, St, Ld, EE, HB, RT, sid):
        """A delivered message at term t that the receiver accepts."""
        bump = msg & (t > T)
        return (
            torch.where(msg, t, T),
            torch.where(bump, 0, V),
            torch.where(msg, ROLE_FOLLOWER, St),
            torch.where(msg, sid + 1, Ld),
            torch.where(msg, 0, EE),
            torch.where(bump, 0, HB),
            torch.where(bump, draw(torch.where(msg, t, T)), RT),
        )

    # ---- wave 3: appends (winner noops and catch-ups) and, with pre-vote,
    # the real vote requests, per receiver in sender order.  A probe that
    # does not match starts a retry chain, applied after the wave.
    ph("general.wave3")
    ack3, ndg3, ndg3_t, retry3 = [], [], [], []
    r_grants, r_resps, r_snaps = [], [], []
    for sid in range(P):
        e_s, erev_s = E[sid], Erev[sid]
        agree_s = agree_run[sid]
        t_row = term[sid][None, :]
        dmask = e_s & member & (noop_w3[sid][None, :] | cu[sid])
        msg = dmask & (t_row >= T)
        ndg = dmask & (t_row < T)
        ndg3_t.append(torch.where(ndg, T, 0))
        # First-probe prev: a member never acked since this owner's
        # election probes from the noop, everyone else from the owner's
        # current last.
        prev_row = torch.where(
            matched3[sid] == 0, TS[sid][None, :] - 1, li2[sid][None, :]
        )
        probe_ok = agree_s >= prev_row
        retry3.append(msg & ~probe_ok & erev_s & ~_cut_before(ndg & erev_s, 0))
        adopt = msg & probe_ok
        T, V, St, Ld, EE, HB, RT = follow(msg, t_row, T, V, St, Ld, EE, HB, RT, sid)
        C = torch.where(adopt, torch.maximum(C, C_send[sid][None, :]), C)
        ack3.append(adopt & erev_s)
        ndg3.append(ndg)
        in_s = adopt | ((p_idx == sid) & adopt.any(0)[None, :])
        agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_s)
        LI = torch.where(adopt, li2[sid][None, :], LI)
        LT = torch.where(adopt, lt2[sid][None, :], LT)
        if pv:
            # The pre-winner's real vote request, after s's appends.
            rq = rqt2[sid][None, :]
            r_del = e_s & real_req[sid][None, :] & promotable
            open_rq = r_del & ~(r_del & (rq > T) & in_lease(Ld, EE))
            rbump = open_rq & (rq > T)
            T = torch.where(rbump, rq, T)
            V = torch.where(rbump, 0, V)
            Ld = torch.where(rbump, 0, Ld)
            St = torch.where(rbump, ROLE_FOLLOWER, St)
            EE = torch.where(rbump, 0, EE)
            HB = torch.where(rbump, 0, HB)
            RT = torch.where(rbump, draw(T), RT)
            at = open_rq & (T == rq)
            g = at & (V == 0) & (Ld == 0) & up_to_date(sid, LT, LI)
            rej = at & ~g
            r_snaps.append(C)
            rc = C_send[sid][None, :]
            vff = rej & (St != ROLE_LEADER) & (rc > C) & (rc <= agree_s)
            V = torch.where(g, sid + 1, V)
            EE = torch.where(g, 0, EE)
            C = torch.where(vff, rc, C)
            r_grants.append(g)
            r_resps.append(at)
    ack3, ndg3, ndg3_t, retry3 = map(torch.stack, (ack3, ndg3, ndg3_t, retry3))
    # A retry chain survives to the reject-processing wave only while its
    # sender is still the same-term leader.
    retry3_fire = retry3 & ((T == term) & (St == ROLE_LEADER))[:, None, :]

    def stage_fold(T, V, St, Ld, EE, HB, RT, RA, matched3, C, TS, ack, ndg,
                   ndg_t, sent_term, sent_idx):
        """The ack/nudge fold of waves 4 and 6: per sender, acks and nudges
        interleave in receiver order, the first effective nudge deposes it
        and drops every later ack; then each owner's quorum commit off its
        cut-off row."""
        eff_n = ndg & Erev & (ndg_t > T[:, None, :])
        was_lead = St == ROLE_LEADER
        ack_eff = (
            ack
            & ~_cut_before(eff_n, 1)
            & ((T == sent_term) & was_lead)[:, None, :]
        )
        matched3 = torch.where(
            ack_eff, torch.maximum(matched3, sent_idx[:, None, :]), matched3
        )
        RA = RA | ack_eff
        dep_t = torch.where(eff_n, ndg_t, 0).amax(1)
        dep = eff_n.any(1)
        T = torch.where(dep, torch.maximum(T, dep_t), T)
        V = torch.where(dep, 0, V)
        St = torch.where(dep, ROLE_FOLLOWER, St)
        Ld = torch.where(dep, 0, Ld)
        EE = torch.where(dep, 0, EE)
        HB = torch.where(dep, 0, HB)
        RT = torch.where(dep, draw(T), RT)
        rows = matched3.transpose(1, 2)  # [owner, G, target]
        mci = torch.minimum(
            kernels.committed_index(rows, st.voter_mask.t()[None].expand(P, G, P)),
            kernels.committed_index(rows, st.outgoing_mask.t()[None].expand(P, G, P)),
        )
        ok = was_lead & (mci >= TS) & (mci < kernels.INF)
        c_new = torch.where(ok, torch.maximum(C, mci), C)
        return T, V, St, Ld, EE, HB, RT, RA, matched3, c_new, c_new > C

    # ---- wave 4: the stage fold over the wave-3 acks; with pre-vote, the
    # real tally and its winner effects.
    ph("general.wave4")
    T, V, St, Ld, EE, HB, RT, RA, matched3, C, adv = stage_fold(
        T, V, St, Ld, EE, HB, RT, RA, matched3, C, TS, ack3, ndg3, ndg3_t,
        term, li2,
    )
    if pv:
        C, won, lost = _real_tally(
            st, C, real_req & (St == ROLE_CANDIDATE), r_grants, r_resps,
            r_snaps, Erev, agree_run,
        )
        li2 = LI + won.to(I32)
        lt2 = torch.where(won, T, lt2)
        TS = torch.where(won, li2, TS)
        St = torch.where(won, ROLE_LEADER, St)
        Ld = torch.where(won, self_id, Ld)
        RT = torch.where(won | lost, draw(T), RT)
        EE = torch.where(won | lost, 0, EE)
        HB = torch.where(won, 0, HB)
        St = torch.where(lost, ROLE_FOLLOWER, St)
        matched3 = torch.where(won[:, None, :], 0, matched3)
        matched3 = torch.where(won[:, None, :] & eye, li2[:, None, :], matched3)
        RA = RA & ~won[:, None, :]
        LI = torch.where(won, li2, LI)
        LT = torch.where(won, lt2, LT)

    def apply_retry(fire, t_send, csend, St, Ld, EE, C, LI, LT, agree_run):
        """Retry resends (the maybe_decr chain) landing as wholesale
        adoption one wave after the reject, per sender in index order.  T
        is read-only: a resend is accepted only at an equal term."""
        acc_rows = []
        for sid in range(P):
            acc = fire[sid] & (t_send[sid][None, :] >= T)
            St = torch.where(acc, ROLE_FOLLOWER, St)
            Ld = torch.where(acc, sid + 1, Ld)
            EE = torch.where(acc, 0, EE)
            LI = torch.where(acc, li2[sid][None, :], LI)
            LT = torch.where(acc, lt2[sid][None, :], LT)
            C = torch.where(acc, torch.maximum(C, csend[sid][None, :]), C)
            in_s = acc | ((p_idx == sid) & acc.any(0)[None, :])
            agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_run[sid])
            acc_rows.append(acc)
        return torch.stack(acc_rows), St, Ld, EE, C, LI, LT, agree_run

    retry3_acc, St, Ld, EE, C, LI, LT, agree_run = apply_retry(
        retry3_fire, term, C_send, St, Ld, EE, C, LI, LT, agree_run
    )

    # ---- wave 5: commit-advance re-broadcasts and, with pre-vote, the
    # winners' noop broadcasts, one sender-ordered pass.  Re-broadcasts
    # carry prev = the leader's current last; a pre-vote winner's noop
    # carries its pre-noop cursor.
    ph("general.wave5")
    C_send5 = C
    if pv:
        w5_prev = torch.where(won, li2 - 1, li2)
        w5_noop = won
        sent_term5 = torch.where(won, rqt2, term)
    else:
        w5_prev, w5_noop, sent_term5 = li2, no, term
    ack5, ndg5, ndg5_t, retry5 = [], [], [], []
    for sid in range(P):
        e_s, erev_s = E[sid], Erev[sid]
        agree_s = agree_run[sid]
        m3 = matched3[sid]
        t_row = sent_term5[sid][None, :]
        noop_d = e_s & member & w5_noop[sid][None, :]
        dmask = (e_s & member & adv[sid][None, :] & ((m3 > 0) | resumed2[sid])) | noop_d
        msg = dmask & (t_row >= T)
        ndg = dmask & (t_row < T)
        ndg5_t.append(torch.where(ndg, T, 0))
        prev_row = torch.where(m3 == 0, TS[sid][None, :] - 1, w5_prev[sid][None, :])
        probe_ok = agree_s >= prev_row
        retry5.append(msg & ~probe_ok & erev_s & ~_cut_before(ndg & erev_s, 0))
        adopt = msg & probe_ok
        T, V, St, Ld, EE, HB, RT = follow(msg, t_row, T, V, St, Ld, EE, HB, RT, sid)
        C = torch.where(adopt & noop_d, torch.maximum(C, C_send5[sid][None, :]), C)
        LI = torch.where(adopt, li2[sid][None, :], LI)
        LT = torch.where(adopt, lt2[sid][None, :], LT)
        ack5.append(adopt & erev_s)
        ndg5.append(ndg)
        in_s = adopt | ((p_idx == sid) & adopt.any(0)[None, :])
        agree_run = _merge_agree(agree_run, in_s, li2[sid], agree_s)
    ack5, ndg5, ndg5_t, retry5 = map(torch.stack, (ack5, ndg5, ndg5_t, retry5))
    retry5_fire = retry5 & ((T == sent_term5) & (St == ROLE_LEADER))[:, None, :]
    retry5_acc, St, Ld, EE, C, LI, LT, agree_run = apply_retry(
        retry5_fire, sent_term5, torch.where(w5_noop, C_send5, 0), St, Ld,
        EE, C, LI, LT, agree_run,
    )
    ack5 = ack5 | retry3_acc | retry5_acc

    # ---- wave 6: the stage fold over the wave-5 acks, then the settled
    # commit propagated to in-sync sendable members, whose sends draw
    # nudges from higher-term receivers.
    ph("general.wave6")
    T, V, St, Ld, EE, HB, RT, RA, matched3, C, _ = stage_fold(
        T, V, St, Ld, EE, HB, RT, RA, matched3, C, TS, ack5, ndg5, ndg5_t,
        sent_term5, li2,
    )
    # Against what each sender's appends carried: the wave-3 snapshot, or
    # the wave-5 one for a pre-vote winner's noop.
    csend6 = torch.where(won, C_send5, C_send) if pv else C_send
    send6 = (
        E
        & member
        & (St == ROLE_LEADER)[:, None, :]
        & ((matched3 > 0) | resumed2)
        & (C > csend6)[:, None, :]
    )
    elig6 = (
        send6
        & (sent_term5[:, None, :] >= T[None, :, :])
        & ((agree_run >= li2[:, None, :]) | Erev)
    )
    C = torch.maximum(C, torch.where(elig6, C[:, None, :], 0).amax(0))
    RA = RA | (elig6 & Erev)
    ndg6 = send6 & (sent_term5[:, None, :] < T[None, :, :]) & Erev
    dep6_t = torch.where(ndg6, T[None, :, :], 0).amax(1)
    dep6 = ndg6.any(1) & (dep6_t > T)
    T = torch.where(dep6, dep6_t, T)
    V = torch.where(dep6, 0, V)
    St = torch.where(dep6, ROLE_FOLLOWER, St)
    Ld = torch.where(dep6, 0, Ld)
    EE = torch.where(dep6, 0, EE)
    HB = torch.where(dep6, 0, HB)
    RT = torch.where(dep6, draw(T), RT)

    # ---- the round's append workload at the acting leader, with the same
    # nudge cutoffs on its ack stream.
    ph("general.workload")
    is_leader = (St == ROLE_LEADER) & alive
    has_leader = is_leader.any(0)
    lead_term = torch.where(is_leader, T, -1).amax(0)
    is_acting = is_leader & (T == lead_term)
    first_l = torch.where(is_acting, p_idx, P).amin(0)
    is_acting_leader = (p_idx == first_l) & has_leader
    n_app, blocked = _drop_proposals(
        torch.where(has_leader, append_n, 0), is_acting_leader, transferee
    )
    sent_b = has_leader & (n_app > 0)
    lead_pre_last = torch.where(is_acting_leader, LI, 0).amax(0)
    LI = LI + torch.where(is_acting_leader, n_app, 0)
    LT = torch.where(is_acting_leader & (n_app > 0), lead_term, LT)
    lead_last = torch.where(is_acting_leader, LI, 0).amax(0)
    lead_last_term = torch.where(is_acting_leader, LT, 0).amax(0)
    reach_b = (E & is_acting_leader[:, None, :]).any(0)  # [P_v, G]
    ack_path = (E & is_acting_leader[None, :, :]).any(1)  # v -> l
    acting_f = is_acting_leader.to(I32)
    acting_row0 = _weighted_row(matched3, acting_f)
    resumed_act = (resumed2 & is_acting_leader[:, None, :]).any(0)
    agree_act = _weighted_row(agree_run, acting_f)
    pr_ok = (acting_row0 > 0) | resumed_act
    ts_acting = _weighted_row(TS, acting_f)
    send_w = sent_b & reach_b & member & ~is_acting_leader & pr_ok
    sync_msg = send_w & (T <= lead_term)
    ndg_w = send_w & (T > lead_term) & ack_path
    depw_t = torch.where(ndg_w, T, 0).amax(0)
    cutw = _cut_before(ndg_w, 0)
    # First-probe prev, or the surviving retry chain: the acting leader is
    # deposed only by these very nudges, so ~cutw is the survival gate.
    probe_w = agree_act >= torch.where(
        acting_row0 == 0, ts_acting[None, :] - 1, lead_pre_last[None, :]
    )
    sync_b = sync_msg & (probe_w | (ack_path & ~cutw))
    bump_b = sync_msg & (T < lead_term)
    T = torch.where(sync_msg, lead_term, T)
    St = torch.where(sync_msg, ROLE_FOLLOWER, St)
    V = torch.where(bump_b, 0, V)
    Ld = torch.where(sync_msg, first_l + 1, Ld)
    EE = torch.where(sync_msg, 0, EE)
    HB = torch.where(bump_b, 0, HB)
    RT = torch.where(bump_b, draw(T), RT)
    LI = torch.where(sync_b, lead_last, LI)
    LT = torch.where(sync_b, lead_last_term, LT)
    in_sb = sync_b | (is_acting_leader & sent_b)
    agree_run = _merge_agree(agree_run, in_sb, lead_last, agree_act)
    # The acting leader's ack stream, cut at the first workload nudge.
    ack_w = sync_b & ack_path & ~cutw
    acting_row = torch.where(
        ack_w | (is_acting_leader & sent_b),
        torch.maximum(acting_row0, lead_last),
        acting_row0,
    )
    matched3 = torch.where(
        is_acting_leader[:, None, :], acting_row[None, :, :], matched3
    )
    RA = RA | (is_acting_leader[:, None, :] & ack_w[None, :, :])
    mci_b = torch.minimum(
        _quorum_index(acting_row, st.voter_mask),
        _quorum_index(acting_row, st.outgoing_mask),
    )
    commit_ok = sent_b & (mci_b >= ts_acting) & (mci_b < kernels.INF)
    lead_commit_old = torch.where(is_acting_leader, C, 0).amax(0)
    lead_commit = torch.where(
        commit_ok, torch.maximum(lead_commit_old, mci_b), lead_commit_old
    )
    C = torch.where(is_acting_leader, lead_commit, C)
    C = torch.where(sync_b, torch.maximum(C, lead_commit), C)
    # Workload nudges depose the acting leader at round end.
    dw = is_acting_leader & (ndg_w.any(0) & (depw_t > lead_term))[None, :]
    T = torch.where(dw, depw_t[None, :], T)
    V = torch.where(dw, 0, V)
    St = torch.where(dw, ROLE_FOLLOWER, St)
    Ld = torch.where(dw, 0, Ld)
    EE = torch.where(dw, 0, EE)
    HB = torch.where(dw, 0, HB)
    RT = torch.where(dw, draw(T), RT)

    if transferee is not None:
        # The reset-abort: only standing leaders keep their transferee.
        transferee = torch.where(St == ROLE_LEADER, transferee, 0)
    out = SimState(
        term=T,
        state=St,
        vote=V,
        leader_id=Ld,
        election_elapsed=EE,
        heartbeat_elapsed=HB,
        randomized_timeout=RT,
        last_index=LI,
        last_term=LT,
        commit=C,
        matched=matched3,
        term_start_index=TS,
        agree=agree_run,
        voter_mask=st.voter_mask,
        outgoing_mask=st.outgoing_mask,
        learner_mask=st.learner_mask,
        recent_active=RA,
        transferee=transferee,
    )
    # campaign() calls: the tick-time campaigns plus, with pre-vote, the
    # pre-winners' real campaigns; heartbeats exclude the ones the
    # check-quorum boundary suppressed (hb_send).  A conf-change proposal
    # is recorded at the workload stage, where the entry is appended last
    # in the round's batch: a nudge that deposes the acting leader
    # afterwards does not unrecord it (the reconfig runner's gate sees the
    # deposed owner and retries).
    return out, _RoundFacts(
        want_campaign, hb_send, won.any(0), real_req if pv else None,
        observed_won=True, lead=(has_leader, first_l, lead_last, lead_term),
        blocked=blocked,
    )


class _CarryLayout(NamedTuple):
    """What rides a compiled round's carry, in order: the SimState
    `fields` that are present (recent_active excluded), the packed
    recent_active words, the counter plane, the health planes and their
    window_pos, and the black box's four planes and its round_idx; `link`
    says whether the round's inputs end in a link plane."""

    fields: tuple
    packed: bool
    counters: bool
    health: bool
    blackbox: bool
    link: bool


def _scalar(v, device) -> torch.Tensor:
    """A window_pos or round_idx as the 0-d int32 tensor the carry holds."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=I32, device=device)


def _to_carry(layout: _CarryLayout, st: SimState, counters, health, bb, device) -> tuple:
    """The flat tensor carry of a compiled round: recent_active packed
    (pack_ra_carry), window_pos and round_idx as 0-d int32 tensors, as
    the reference carries them."""
    st, words = pack_ra_carry(st)
    out = [getattr(st, f) for f in layout.fields]
    if layout.packed:
        out.append(words)
    if layout.counters:
        out.append(counters)
    if layout.health:
        out += [health.planes, _scalar(health.window_pos, device)]
    if layout.blackbox:
        out += [bb.meta, bb.term, bb.commit, bb.trip_round,
                _scalar(bb.round_idx, device)]
    return tuple(out)


def _from_carry(layout: _CarryLayout, carry: tuple):
    """Inverse of _to_carry: (SimState, counters, HealthState, BlackboxState),
    None where off; window_pos and round_idx stay 0-d tensors."""
    it = iter(carry)
    st = SimState(**{f: next(it) for f in layout.fields})
    if layout.packed:
        st = unpack_ra_carry(st, next(it))
    counters = next(it) if layout.counters else None
    health = HealthState(next(it), next(it)) if layout.health else None
    bb = BlackboxState(*(next(it) for _ in range(5))) if layout.blackbox else None
    return st, counters, health, bb


def compiled_round(cfg: SimConfig, layout: _CarryLayout, carry: tuple,
                   crashed, append_n, link=None) -> tuple:
    """One round of ClusterSim.run_compiled on its flat carry: unpack,
    sim.step with the extras the layout holds, pack.  Pure: it returns a
    fresh carry.  RoundGraph captures it; on the CPU it runs as is."""
    st, counters, health, bb = _from_carry(layout, carry)
    res = step(cfg, st, crashed, append_n, counters=counters, health=health,
               link=link, blackbox=bb)
    if not (layout.counters or layout.health or layout.blackbox):
        res = (res,)
    it = iter(res[1:])
    return _to_carry(
        layout, res[0],
        next(it) if layout.counters else None,
        next(it) if layout.health else None,
        next(it) if layout.blackbox else None,
        st.term.device,
    )


class RoundGraph:
    """One round of ClusterSim.run_compiled captured into a CUDA graph.

    The carry (compiled_round's flat tuple) and the round's constant
    planes live in static buffers, and the graph ends with copies of the
    round's result into the carry buffers, so each replay advances them one
    round in place: the counterpart of the reference's donated,
    double-buffered scan carry.  The plain round's election phase is a
    conditional node (graphs.cond).  Before capture the round runs once
    eagerly with the host branch and once with the election phase forced
    (SimConfig(spmd=True)), on a side stream, so that every kernel of both
    arms is loaded.  `capture_s` is the capture's wall time, `nodes` the
    graph's top-level node count and `branch_nodes` the nodes of its
    conditional bodies.  A capture that fails raises."""

    def __init__(self, cfg: SimConfig, layout: _CarryLayout, carry: tuple,
                 inputs: tuple):
        self.carry = tuple(t.clone() for t in carry)
        self.inputs = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in (cfg, cfg._replace(spmd=True)):
                compiled_round(c, layout, self.carry, *self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.capture = graphs.Capture()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, capture_error_mode="relaxed"), self.capture:
            out = compiled_round(cfg, layout, self.carry, *self.inputs)
            for buf, new in zip(self.carry, out):
                buf.copy_(new)
        self.nodes = graphs.node_count(self.graph)
        self.branch_nodes = self.capture.body_nodes()
        self.graph.instantiate()
        self.capture_s = time.perf_counter() - t0

    def run(self, carry: tuple, inputs: tuple, rounds: int) -> tuple:
        """Copy `carry` and `inputs` into the static buffers, replay the
        graph `rounds` times, and return a fresh copy of the carry."""
        for buf, t in zip(self.carry + self.inputs, tuple(carry) + tuple(inputs)):
            buf.copy_(t)
        for _ in range(rounds):
            self.graph.replay()
        return tuple(t.clone() for t in self.carry)


class ClusterSim:
    """Host-side runner over `step`: holds the state and advances it one
    round per `run_round`.  Planes are peer-major [P, G] on `device`
    (`cuda` unless the caller asks for the CPU).

    With SimConfig(collect_counters=True) every round folds its events
    into an int32 [N_COUNTERS] plane on the device, which drains into
    unbounded host totals on an adaptive cadence; with collect_health=True
    every round updates the HealthState, and an attached `health_monitor`
    (health.HealthMonitor, or anything with its `record`) receives the
    fixed-size summary on the same cadence.  Only the [N_COUNTERS] plane
    and the summary cross to the host, never a [., G] plane.  With
    SimConfig(blackbox=True) every round also folds into the black box
    (BlackboxState), and with a monitor attached each drain reports the
    fixed-size forensics capture to its record_incident once per growth of
    a slot's offender count; forensics(), incident_report() and
    record_safety() read and stamp it.  With
    `chaos` (a chaos.ChaosPlan) attached, run_plan() runs the scenario;
    run_reconfig() runs a membership-change plan and run_reads() a client
    read/write workload; read_index() and lease_read() probe the state.

    With `mesh` (a sharding.Mesh, from inside a rank that sharding.launch
    started) the sim is this rank's block of a mesh run: `cfg` stays the
    whole batch's (promoted to SimConfig(spmd=True), so the plain round
    has no host branch), `state` and the health and black-box planes hold
    the rank's groups only, bootstrapped in place from their global ids
    (sharding.sharded_init_state), every run_* entry point takes the same
    whole-batch inputs on every rank and keeps the rank's block, and every
    result that covers the whole batch (the counter totals, the health
    summary, the forensics capture, the scenario reports and fused_frac)
    is reduced over the ranks, so each rank returns the reference's
    values.  read_index() and lease_read() answer for the rank's groups.
    Every rank calls the same entry points in the same order: the drains,
    accessors and runners issue collectives."""

    _DRAIN_MAX = 128  # never let a window exceed this many rounds

    def __init__(
        self,
        cfg: SimConfig,
        voter_mask: Optional[torch.Tensor] = None,
        outgoing_mask: Optional[torch.Tensor] = None,
        learner_mask: Optional[torch.Tensor] = None,
        health_monitor=None,
        chaos=None,
        mesh=None,
        mesh_axis: str = "groups",
        device: DeviceLike = None,
    ):
        if mesh is not None and not cfg.spmd:
            cfg = cfg._replace(spmd=True)
        self.cfg = cfg
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is None:
            self.device = resolve_device(device)
            self._lcfg = cfg
            self.state = init_state(
                cfg, voter_mask, outgoing_mask, learner_mask, device=self.device
            )
        else:
            from . import sharding as sharding_mod

            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
            self.device = mesh.device
            # The rank's planes' config: its block's width, its global ids.
            self._lcfg = sharding_mod.local_config(cfg, mesh)
            self.state = sharding_mod.sharded_init_state(
                cfg, mesh, voter_mask, outgoing_mask, learner_mask, axis=mesh_axis
            )
        # The attached chaos plan (a chaos.ChaosPlan, or a CompiledChaos on
        # this sim's device); run_plan() runs it, compiling a plan lazily at
        # this sim's batch shape and caching the schedule and its runner.
        self._chaos = chaos
        self._chaos_compiled = None
        self._chaos_runner = None
        # run_reconfig's cache: (plan, chaos_plan, compiled, runner, mode),
        # and the op-protocol state its last run ended in.
        self._reconfig_runner = None
        self._reconfig_state = None
        # run_reads' cache: (plan, chaos_plan, reconfig_plan, compiled,
        # runner, mode), and the outstanding-read carry its last run ended in.
        self._read_runner = None
        self._read_carry = None
        self._counters: Optional[torch.Tensor] = None
        self._health: Optional[HealthState] = None
        self.health_monitor = health_monitor
        if (
            health_monitor is not None
            and cfg.collect_health
            and health_monitor.snapshot_fn is None
        ):
            # Post-mortems snapshot the worst groups through explain().
            health_monitor.snapshot_fn = self.explain
        self._rounds_since_drain = 0
        self._drain_every = self._DRAIN_MAX
        # run_compiled's CUDA graphs, by carry layout.
        self._round_graphs: Dict[_CarryLayout, RoundGraph] = {}
        if cfg.collect_counters:
            # The device plane is int32, so it drains into these host
            # totals every _drain_every rounds.  The cadence starts at one
            # round and doubles toward a G-scaled cap while the windows
            # stay far below 2**31 events (halving back under pressure).
            self._counters = kernels.zero_counters(self.device)
            self._host_counters = [0] * kernels.N_COUNTERS
            self._drain_every = 1
            self._drain_cap = max(
                1, min(self._DRAIN_MAX, (1 << 31) // (256 * cfg.n_groups))
            )
        if cfg.collect_health:
            self._health = init_health(self._lcfg, self.device)
        self._blackbox: Optional[BlackboxState] = None
        if cfg.blackbox:
            self._blackbox = init_blackbox(self._lcfg, self.device)
            # Per-slot offender counts already reported to the monitor, so
            # a drain reports each incident once.
            self._bb_seen = [0] * kernels.N_SAFETY

    def _summary(self, planes: torch.Tensor):
        """kernels.health_summary at this config's thresholds, on the
        planes' device; on a mesh, of the whole batch (sharding's
        reduction)."""
        from . import sharding as sharding_mod

        return sharding_mod.health_summary(self._lcfg, planes)

    @staticmethod
    def _download_summary(summary) -> dict:
        """The four summary vectors in one device-to-host copy, as the
        summary dict."""
        sizes = [t.numel() for t in summary]
        flat = torch.cat(summary).tolist()
        parts, at = [], 0
        for n in sizes:
            parts.append(flat[at:at + n])
            at += n
        return HealthMonitor.summary_dict(*parts)

    def _drain(self, summary: bool = True) -> None:
        """The host boundary, synchronous: the counter plane (a fresh zero
        plane takes its place) folds into the host totals, with the wrap
        check and the cadence adaptation; with `summary` and a monitor
        attached, the health summary goes to it, and with the black box on,
        each safety slot whose offender count grew since the last report
        goes to its record_incident.  run_round drains on the cadence,
        counters() with summary=False."""
        counters = self._counters
        self._rounds_since_drain = 0
        if counters is not None:
            from . import sharding as sharding_mod

            self._counters = kernels.zero_counters(self.device)
            counters = sharding_mod.reduce_stats(self._lcfg, counters)
            peak = 0
            for i, v in enumerate(counters.tolist()):
                if v < 0:
                    raise RuntimeError(
                        "device event counter wrapped int32 within one drain "
                        "window; totals are corrupt — rerun with more frequent "
                        "ClusterSim.counters() calls or fewer events per round"
                    )
                peak = max(peak, v)
                self._host_counters[i] += v
            # Stay well clear of 2**31 a window without syncing more often
            # than needed.
            if peak > (1 << 29) and self._drain_every > 1:
                self._drain_every //= 2
            elif peak < (1 << 26) and self._drain_every < self._drain_cap:
                self._drain_every *= 2
        if summary and self._health is not None and self.health_monitor is not None:
            self.health_monitor.record(
                self._download_summary(self._summary(self._health.planes))
            )
        if summary and self._blackbox is not None and self.health_monitor is not None:
            capture = self.forensics()
            for s, name in enumerate(kernels.SAFETY_NAMES):
                n = capture["counts"][name]
                if n > self._bb_seen[s]:
                    self._bb_seen[s] = n
                    self.health_monitor.record_incident({
                        "slot": name, "count": n,
                        "offenders": capture["offenders"][name],
                    })

    def _round_planes(self, crashed, append_n, link):
        """The round's constant planes on this sim's device, with the
        defaults (no crashes, no appends) filled in; on a mesh, whole-batch
        planes are cut to the rank's block."""
        G, P = self._lcfg.n_groups, self._lcfg.n_peers
        if crashed is None:
            crashed = torch.zeros((P, G), dtype=torch.bool, device=self.device)
        if append_n is None:
            append_n = torch.zeros((G,), dtype=I32, device=self.device)
        crashed, append_n, link = self._block(crashed, append_n, link)
        crashed = crashed.to(device=self.device, dtype=torch.bool)
        append_n = append_n.to(device=self.device, dtype=I32)
        if link is not None:
            link = link.to(device=self.device, dtype=torch.bool)
        return crashed, append_n, link

    def _block(self, *xs):
        """Whole-batch [..., G] planes cut to this rank's block (the
        identity off a mesh)."""
        if self.mesh is None:
            return xs
        from . import sharding as sharding_mod

        return sharding_mod._local_planes(self._lcfg, *xs)

    def _counts_window(self) -> bool:
        """Whether rounds count toward the drain window: with counters or
        health planes, or a black box with a monitor to report to."""
        return (
            self._counters is not None or self._health is not None
            or (self._blackbox is not None and self.health_monitor is not None)
        )

    def run_round(self, crashed=None, append_n=None, link=None) -> SimState:
        """One protocol round; crashed bool[P, G] and append_n int32[G]
        default to no crashes and no appends.  `link` (optional bool[P, P,
        G]) threads the directed reachability plane through the step; None
        keeps the all-visible round."""
        crashed, append_n, link = self._round_planes(crashed, append_n, link)
        cc, ch = self._counters is not None, self._health is not None
        bb = self._blackbox is not None
        if not (cc or ch or bb):
            self.state = step(self._lcfg, self.state, crashed, append_n, link=link)
            return self.state
        res = step(
            self._lcfg, self.state, crashed, append_n, counters=self._counters,
            health=self._health, link=link, blackbox=self._blackbox,
        )
        self.state = res[0]
        if cc:
            self._counters = res[1]
        if ch:
            self._health = res[1 + cc]
        if bb:
            self._blackbox = res[-1]
        if not self._counts_window():
            return self.state
        self._rounds_since_drain += 1
        if self._rounds_since_drain >= self._drain_every:
            self._drain()
        return self.state

    def run(self, rounds: int, crashed=None, append_n=None) -> SimState:
        for _ in range(rounds):
            self.run_round(crashed, append_n)
        return self.state

    def _layout(self, has_link: bool) -> "_CarryLayout":
        st, words = pack_ra_carry(self.state)
        return _CarryLayout(
            fields=tuple(f for f in SimState._fields if getattr(st, f) is not None),
            packed=words is not None,
            counters=self._counters is not None,
            health=self._health is not None,
            blackbox=self._blackbox is not None,
            link=has_link,
        )

    def _compiled_runner(self, layout: "_CarryLayout", carry: tuple,
                         inputs: tuple) -> "RoundGraph":
        """The CUDA graph of one round for this carry layout (the state,
        recent_active packed, the extras that are on, link threading),
        captured at first use and cached, as the reference caches its
        scans by link threading."""
        graph = self._round_graphs.get(layout)
        if graph is None:
            graph = self._round_graphs[layout] = RoundGraph(
                self._lcfg, layout, carry, inputs
            )
        return graph

    def _carry(self, layout: "_CarryLayout") -> tuple:
        return _to_carry(layout, self.state, self._counters, self._health,
                         self._blackbox, self.device)

    def _set_carry(self, layout: "_CarryLayout", carry: tuple, rounds: int) -> None:
        """Take a segment's end carry back into the sim; window_pos and
        round_idx advance by the host-known round count, as the device
        scalars did."""
        self.state, counters, health, bb = _from_carry(layout, carry)
        if layout.counters:
            self._counters = counters
        if layout.health:
            self._health = HealthState(
                health.planes,
                (self._health.window_pos + rounds) % self.cfg.health_window,
            )
        if layout.blackbox:
            self._blackbox = bb._replace(round_idx=self._blackbox.round_idx + rounds)

    def run_compiled(
        self, rounds: int, crashed=None, append_n=None, link=None
    ) -> SimState:
        """Advance `rounds` lockstep rounds for constant crashed, append_n
        and link planes (the bench schedule), equal to `rounds` run_round
        calls bit for bit, drains included.

        On a CUDA device one round is captured into a CUDA graph at first
        use (`RoundGraph`: the carry in static buffers, recent_active
        packed 32:1 along G by pack_ra_carry, window_pos and round_idx as
        0-d device scalars, the plain round's election branch a
        conditional node) and replayed once a round: one host call a round
        and no device sync, the counterpart of the reference's donated
        `lax.scan`.  A capture that fails raises; nothing falls back to the
        eager rounds.  On the CPU the same round function runs as a host
        loop.

        Segments and drains follow the reference: with counters on, a
        segment is at most the drain cap's rounds (a residual run_round
        window is drained first where it and the segment would pass the
        cap); with health or a black box and a monitor attached, at most
        the drain cadence's; each segment's carry comes back into the sim
        (fresh tensors, which no later replay overwrites) and the drain
        runs on the same cadence as run_round's.  The drain stays
        synchronous and outside the graph, so no collective of a mesh run
        is ever captured."""
        crashed, append_n, link = self._round_planes(crashed, append_n, link)
        cc = self._counters is not None
        ch = self._health is not None
        bb = self._blackbox is not None
        if cc:
            seg_max = self._drain_cap
        elif (ch or bb) and self.health_monitor is not None:
            seg_max = self._drain_every
        else:
            seg_max = rounds
        inputs = (crashed, append_n) + ((link,) if link is not None else ())
        done = 0
        while done < rounds:
            seg = min(seg_max, rounds - done)
            if (cc and self._rounds_since_drain
                    and self._rounds_since_drain + seg > self._drain_cap):
                # A residual run_round window plus this segment would pass
                # the int32-safe cap: drain it first.
                self._drain()
            layout = self._layout(link is not None)
            carry = self._carry(layout)
            if self.device.type == "cuda":
                carry = self._compiled_runner(layout, carry, inputs).run(
                    carry, inputs, seg
                )
            else:
                for _ in range(seg):
                    carry = compiled_round(self._lcfg, layout, carry, *inputs)
            self._set_carry(layout, carry, seg)
            done += seg
            if self._counts_window():
                self._rounds_since_drain += seg
                if self._rounds_since_drain >= self._drain_every:
                    self._drain()
        return self.state

    # --- mesh placement (the identity off a mesh) ---

    def _shard_chaos_schedule(self, compiled):
        """This rank's block of a whole-batch compiled chaos schedule; runs
        before make_runner, so the cached runner holds the placed one."""
        if self.mesh is None or compiled is None:
            return compiled
        from . import sharding as sharding_mod

        return sharding_mod.shard_chaos(compiled, self.mesh, self.mesh_axis)

    def _shard_reconfig_schedule(self, compiled):
        """This rank's block of a whole-batch compiled reconfig schedule;
        the op-protocol carry derives from the already-placed state."""
        if self.mesh is None or compiled is None:
            return compiled
        from . import sharding as sharding_mod

        return sharding_mod.shard_reconfig(compiled, None, self.mesh, self.mesh_axis)[0]

    def _shard_client_schedule(self, compiled):
        """This rank's block of a whole-batch compiled client schedule, the
        packed read-fire words split or kept whole
        (sharding.fire_words_tile)."""
        if self.mesh is None or compiled is None:
            return compiled
        from . import sharding as sharding_mod

        return sharding_mod.shard_client(compiled, None, self.mesh, self.mesh_axis)[0]

    def _reduce_results(self, stats, *sums):
        """A runner's chaos stats and other int32 accumulators of the whole
        batch: on a mesh each summed over the ranks, the stats' running
        maximum taken as a MAX (the identity off a mesh)."""
        from . import chaos as chaos_mod
        from . import sharding as sharding_mod

        return (sharding_mod.reduce_stats(self._lcfg, stats, (chaos_mod.CS_MAX_STREAK,)),
                *(sharding_mod.reduce_stats(self._lcfg, v) for v in sums))

    def _chaos_runner_for(self, plan=None):
        """(CompiledChaos, runner) for `plan` (default: the attached one);
        the attached plan's are cached, so repeated run_plan() calls
        compile its schedule once."""
        from . import chaos as chaos_mod
        from . import runner as runner_mod

        plan = plan if plan is not None else self._chaos
        if plan is None:
            raise RuntimeError("no chaos plan; construct with chaos= or pass one")
        if plan is self._chaos and self._chaos_runner is not None:
            return self._chaos_compiled, self._chaos_runner
        if isinstance(plan, chaos_mod.CompiledChaos):
            compiled = plan
        else:
            compiled = chaos_mod.compile_plan(plan, self.cfg.n_groups, self.device)
        compiled = self._shard_chaos_schedule(compiled)
        runner = runner_mod.make_runner(self._lcfg, (compiled,))
        if plan is self._chaos:
            self._chaos_compiled, self._chaos_runner = compiled, runner
        return compiled, runner

    def run_plan(self, plan=None) -> dict:
        """Run the attached (or given) chaos plan over every round of its
        schedule and return the scenario report (HealthMonitor.chaos_report:
        MTTR and time to re-elect off the health planes, and the per-round
        safety-invariant counts), which also goes to the attached monitor's
        record_scenario.  The state and health planes advance in place.
        Requires SimConfig(collect_health=True): the stats ride on the
        HP_LEADERLESS plane.  With the black box on, every round folds into
        it.  The two result vectors cross to the host in one copy at the
        end of the run."""
        compiled, runner = self._chaos_runner_for(plan)
        health = self._require_health()
        out = runner(self.state, health, *self._bb_args())
        (self.state, self._health), (stats, safety) = out[:2], out[-2:]
        if self._blackbox is not None:
            self._blackbox = out[2]
        stats, safety = self._reduce_results(stats, safety)
        both = torch.cat([stats, safety]).tolist()
        report = HealthMonitor.chaos_report(
            both[: stats.numel()], both[stats.numel():], compiled.n_rounds
        )
        if self.health_monitor is not None:
            self.health_monitor.record_scenario(report)
        return report

    def run_reconfig(
        self, plan, chaos_plan=None, stall_timeouts: int = 4,
        split: bool = False, split_k: int = 8, split_window: int = 4,
    ) -> dict:
        """Run a membership-change plan (reconfig.ReconfigPlan or
        CompiledReconfig on this sim's device) over every round of its
        schedule, optionally composed with a chaos plan of equal length
        (reconfig during partitions, loss and crashes), and return the
        scenario report (HealthMonitor.reconfig_report), which also goes to
        the attached monitor's record_reconfig.

        Requires SimConfig(collect_health=True).  The state and health
        planes advance in place, and the config masks end in the plan's
        final configuration; a plan must start from its bootstrap masks
        (reconfig.initial_masks).  The compiled schedules and the runner
        are cached while the same plan objects come back.  A group still
        joint whose commit has been flat for `stall_timeouts *
        election_tick` rounds counts as reconfig-stalled.

        `split=True` runs the plan through reconfig.make_split_runner: the
        steady stretches between op windows (`split_window` rounds around
        each op) run the fused kernel in `split_k`-round blocks, the rest
        the general rounds, with the same result; the report then also
        holds `fused_rounds`, `total_rounds` (group-rounds) and
        `fused_frac`.  With collect_counters on, the counter plane threads
        through the split run and drains into the host totals after it.  A
        black-box config never fuses (steady_mask rejects it), so
        `split=True` there runs the unsplit runner and reports fused_rounds
        0.  With the black box on, every round folds into it."""
        from . import chaos as chaos_mod
        from . import reconfig as reconfig_mod
        from . import runner as runner_mod

        health = self._require_health()
        G = self.cfg.n_groups
        fused_zero = split and self.cfg.blackbox
        split = split and not fused_zero
        if isinstance(plan, reconfig_mod.ReconfigPlan):
            # Plans apply absolute target masks walked from the bootstrap
            # config, so the sim must start in exactly that config.
            from . import sharding as sharding_mod

            want = self._block(*reconfig_mod.initial_masks(plan, G, self.device))
            cur = (self.state.voter_mask, self.state.outgoing_mask,
                   self.state.learner_mask)
            same = all(torch.equal(c, w) for c, w in zip(cur, want))
            if not sharding_mod.all_ranks(self._lcfg, same):
                raise ValueError(
                    "sim state masks do not match the plan's bootstrap "
                    "config (voters/learners); start from "
                    "ClusterSim(cfg, *reconfig.initial_masks(plan, G)) — "
                    "plans apply absolute target masks, not deltas"
                )
        # The cache compares plan objects with `is`, like the chaos cache.
        wc = split and self._counters is not None
        mode = ("split", split_k, split_window, wc) if split else "unsplit"
        cached = self._reconfig_runner
        if (
            cached is None
            or cached[0] is not plan
            or cached[1] is not chaos_plan
            or cached[4] != mode
        ):
            if isinstance(plan, reconfig_mod.CompiledReconfig):
                compiled = plan
            else:
                compiled = reconfig_mod.compile_plan(plan, G, self.device)
            if chaos_plan is None or isinstance(chaos_plan, chaos_mod.CompiledChaos):
                chaos_compiled = chaos_plan
            else:
                chaos_compiled = chaos_mod.compile_plan(chaos_plan, G, self.device)
            segments = None
            if split and self.mesh is not None:
                # The split plan of the whole batch's schedule: a block's own
                # would differ from rank to rank.
                segments = reconfig_mod.split_plan(
                    compiled, split_k, chaos_compiled, split_window
                )
            compiled = self._shard_reconfig_schedule(compiled)
            chaos_compiled = self._shard_chaos_schedule(chaos_compiled)
            runner = runner_mod.make_runner(
                self._lcfg, (compiled, chaos_compiled), split=split, k=split_k,
                window=split_window, with_counters=wc, segments=segments,
            )
            self._reconfig_runner = (plan, chaos_plan, compiled, runner, mode)
        else:
            compiled, runner = cached[2], cached[3]
        # On a mesh the carry of the placed state is already the rank's block.
        rst = reconfig_mod.init_reconfig_state(self.state)
        fused = None
        if split:
            if wc:
                # One counter window spans the whole plan, so the int32 wrap
                # bound must hold for it: settle any open run_round window
                # first, and refuse plans longer than the per-window cap.
                if self._rounds_since_drain:
                    self._drain(summary=False)
                if compiled.n_rounds > self._drain_cap:
                    raise ValueError(
                        f"plan spans {compiled.n_rounds} rounds but the "
                        f"counter drain cap at this batch size is "
                        f"{self._drain_cap} rounds per undrained window; run "
                        "reconfig.make_split_runner directly, managing the "
                        "counter plane yourself, or split the plan"
                    )
            out = runner(self.state, health, rst,
                         *((self._counters,) if wc else ()))
            (self.state, self._health, self._reconfig_state,
             stats, rstats, safety, fused) = out[:7]
            if wc:
                self._counters = out[7]
                self._drain(summary=False)
        else:
            out = runner(self.state, health, rst, *self._bb_args())
            (self.state, self._health, self._reconfig_state,
             stats, rstats, safety) = out[:6]
            if self._blackbox is not None:
                self._blackbox = out[6]
        # One copy for the three result vectors, one each for the two planes
        # the stall rule reads (on a mesh, gathered whole).
        stats, rstats, safety = self._reduce_results(stats, rstats, safety)
        ns, nr = stats.numel(), rstats.numel()
        flat = torch.cat([stats, rstats, safety]).tolist()
        outgoing = self.state.outgoing_mask
        since = self._health.planes[kernels.HP_SINCE_COMMIT]
        if self.mesh is not None:
            from . import sharding as sharding_mod

            outgoing = sharding_mod.gather_groups(self.mesh, outgoing, G)
            since = sharding_mod.gather_groups(self.mesh, since, G)
        n_stuck, worst = HealthMonitor.reconfig_stall_groups(
            outgoing.cpu().numpy(), since.cpu().numpy(),
            self.cfg.election_tick, stall_timeouts=stall_timeouts,
            topk=min(self.cfg.health_topk, G),
        )
        report = HealthMonitor.reconfig_report(
            flat[:ns], flat[ns:ns + nr], flat[ns + nr:], compiled.n_rounds,
            n_stuck, worst,
        )
        if fused is not None or fused_zero:
            from . import sharding as sharding_mod

            fused = sharding_mod.sum_ranks(self._lcfg, fused or 0)
            total = compiled.n_rounds * G
            report["fused_rounds"] = fused
            report["total_rounds"] = total
            report["fused_frac"] = round(fused / total, 4)
        if self.health_monitor is not None:
            self.health_monitor.record_reconfig(report)
        return report

    def run_reads(
        self, plan, chaos_plan=None, reconfig_plan=None,
        split: bool = False, split_k: int = 8,
    ) -> dict:
        """Run a client-read workload (workload.ClientPlan, or a
        CompiledClient on this sim's device) over every round of its
        schedule, optionally composed with a chaos plan and a reconfig plan
        of equal length, and return the scenario report
        (workload.read_report: read counts, the p50/p90/p99 latency in
        rounds, MTTR and the safety counts, the linearizability slots
        included), which also goes to the attached monitor's record_reads.

        Requires SimConfig(collect_health=True); lease-mode reads serve
        locally only under SimConfig(lease_read=True, check_quorum=True) and
        degrade to the ReadIndex round otherwise.  The state and health
        planes advance in place; the compiled schedules and the runner are
        cached while the same plan objects come back.

        `split=True` runs a bare plan through workload.make_split_runner:
        steady stretches whose reads are pure lease serves run the fused
        kernel in `split_k`-round blocks (their receipts fold in closed
        form), the rest the general rounds, with the same result; the
        report then also holds `fused_rounds`, `total_rounds` (group-rounds)
        and `fused_frac`; on a black-box config, which never fuses, it runs
        the unsplit runner and reports fused_rounds 0.  With the black box
        on, every round folds into it.  The five result vectors cross to
        the host in one copy at the end of the run."""
        from . import chaos as chaos_mod
        from . import reconfig as reconfig_mod
        from . import runner as runner_mod
        from . import workload as workload_mod

        health = self._require_health()
        G = self.cfg.n_groups
        fused_zero = split and self.cfg.blackbox
        split = split and not fused_zero
        mode = ("split", split_k) if split else "unsplit"
        cached = self._read_runner
        if (
            cached is None
            or cached[0] is not plan
            or cached[1] is not chaos_plan
            or cached[2] is not reconfig_plan
            or cached[5] != mode
        ):
            if isinstance(plan, workload_mod.CompiledClient):
                compiled = plan
            else:
                compiled = workload_mod.compile_plan(plan, G, self.device)
            compiled = self._shard_client_schedule(compiled)
            if chaos_plan is None or isinstance(chaos_plan, chaos_mod.CompiledChaos):
                chaos_compiled = chaos_plan
            else:
                chaos_compiled = chaos_mod.compile_plan(chaos_plan, G, self.device)
            if reconfig_plan is None or isinstance(
                reconfig_plan, reconfig_mod.CompiledReconfig
            ):
                reconfig_compiled = reconfig_plan
            else:
                reconfig_compiled = reconfig_mod.compile_plan(
                    reconfig_plan, G, self.device
                )
            chaos_compiled = self._shard_chaos_schedule(chaos_compiled)
            reconfig_compiled = self._shard_reconfig_schedule(reconfig_compiled)
            runner = runner_mod.make_runner(
                self._lcfg, (compiled, chaos_compiled, reconfig_compiled),
                split=split, k=split_k,
            )
            self._read_runner = (
                plan, chaos_plan, reconfig_plan, compiled, runner, mode,
            )
        else:
            compiled, runner = cached[3], cached[4]
        out = runner(
            self.state, health, reconfig_mod.init_reconfig_state(self.state),
            workload_mod.init_read_carry(self._lcfg.n_groups, self.device),
            *self._bb_args(),
        )
        (self.state, self._health, _, stats, _, safety, self._read_carry,
         rdstats, lat_hist) = out[:9]
        if self._blackbox is not None:
            self._blackbox = out[9]
        stats, safety, rdstats, lat_hist = self._reduce_results(
            stats, safety, rdstats, lat_hist
        )
        vecs = (rdstats, workload_mod.latency_percentiles(lat_hist), safety, stats)
        flat = torch.cat(vecs).tolist()
        parts, at = [], 0
        for v in vecs:
            parts.append(flat[at:at + v.numel()])
            at += v.numel()
        report = workload_mod.read_report(*parts, compiled.n_rounds)
        if split or fused_zero:
            from . import sharding as sharding_mod

            fused = sharding_mod.sum_ranks(self._lcfg, out[9] if split else 0)
            total = compiled.n_rounds * G
            report["fused_rounds"] = fused
            report["total_rounds"] = total
            report["fused_frac"] = round(fused / total, 4)
        if self.health_monitor is not None:
            self.health_monitor.record_reads(report)
        return report

    def read_index(self, crashed=None, link=None) -> torch.Tensor:
        """The batched linearizable ReadIndex barrier on the current state
        (see read_index); `link` threads a reachability plane through the
        ack quorum.  int32[G] on this sim's device (on a mesh, the rank's
        block)."""
        if crashed is None:
            crashed = torch.zeros(
                (self._lcfg.n_peers, self._lcfg.n_groups), dtype=torch.bool,
                device=self.device,
            )
        crashed, link = self._block(crashed, link)
        return read_index(self._lcfg, self.state, crashed, link)

    def lease_read(self, crashed=None) -> torch.Tensor:
        """The LeaseBased read probe (kernels.lease_read): int32[G], the
        commit index each group's acting leader would serve locally under
        the check-quorum lease right now, or -1 where the gate fails (no
        lease-holding leader, an uncommitted term, or lease reads off:
        SimConfig(lease_read=True, check_quorum=True) gives a non-trivial
        answer).  Zero message rounds either way; for the full read path
        use step(read_propose=) or workload.make_runner.  On a mesh, the
        rank's block."""
        if crashed is None:
            crashed = torch.zeros(
                (self._lcfg.n_peers, self._lcfg.n_groups), dtype=torch.bool,
                device=self.device,
            )
        (crashed,) = self._block(crashed)
        cfg, st = self.cfg, self.state
        _, served, index = kernels.lease_read(
            st.state, st.term, st.leader_id, st.election_elapsed, st.commit,
            st.term_start_index, crashed, cfg.election_tick,
            cfg.check_quorum and cfg.lease_read, st.transferee,
            st.recent_active, st.voter_mask, st.outgoing_mask,
        )
        return torch.where(served, index, -1)

    def counters(self) -> dict:
        """The event totals as {name: count}: the device plane drains into
        the host totals here (with the wrap check), on demand.  Requires
        SimConfig(collect_counters=True)."""
        if self._counters is None:
            raise RuntimeError(
                "counters disabled; construct with "
                "SimConfig(collect_counters=True)"
            )
        self._drain(summary=False)
        return dict(zip(kernels.COUNTER_NAMES, self._host_counters))

    def reset_counters(self) -> None:
        if self._counters is not None:
            self._counters = kernels.zero_counters(self.device)
            self._host_counters = [0] * kernels.N_COUNTERS
            self._rounds_since_drain = 0

    # --- fleet health (requires SimConfig(collect_health=True)) ---

    def _require_health(self) -> HealthState:
        if self._health is None:
            raise RuntimeError(
                "health planes disabled; construct with "
                "SimConfig(collect_health=True)"
            )
        return self._health

    def health(self) -> dict:
        """The current fleet-health summary as a plain dict (counts,
        lag_hist, worst: see health.HealthMonitor), reduced on the device;
        only the summary crosses to the host.  It also goes to the attached
        HealthMonitor, if any."""
        summary = self._download_summary(
            self._summary(self._require_health().planes)
        )
        if self.health_monitor is not None:
            self.health_monitor.record(summary)
        return summary

    def explain(self, group_id: int) -> dict:
        """Post-mortem for one group: its health-plane column and every
        peer's consensus cursors, O(P) values in one host copy."""
        h = self._require_health()
        g = int(group_id)
        st = self.state
        H = h.planes.shape[0]
        flat = self._group_column(g, [
            h.planes,
            st.term,
            st.state,
            st.commit,
            st.last_index,
            st.leader_id,
            (st.voter_mask | st.outgoing_mask).to(I32),
            st.learner_mask.to(I32),
        ]).tolist()
        planes = flat[:H]
        P = st.term.shape[0]
        cols = [flat[H + i * P:H + (i + 1) * P] for i in range(7)]
        term, role, commit, last_index, leader_id, voter, learner = cols
        return {
            "group": g,
            "health": dict(zip(kernels.HEALTH_PLANE_NAMES, planes)),
            "peers": {
                "term": term,
                "state": role,
                "commit": commit,
                "last_index": last_index,
                "leader_id": leader_id,
                "voter": [bool(v) for v in voter],
                "learner": [bool(v) for v in learner],
            },
        }

    def _group_column(self, g: int, tensors) -> torch.Tensor:
        """Global group g's column of each [..., G] tensor, flattened and
        concatenated (int32).  On a mesh every rank must call it: the
        owning rank fills the column and a SUM over the ranks hands it to
        all of them."""
        if self.mesh is None:
            return torch.cat([t[..., g].reshape(-1).to(I32) for t in tensors])
        from . import sharding as sharding_mod

        lo, hi = self._lcfg.shard.lo, self._lcfg.shard.hi
        j = min(max(g - lo, 0), hi - lo - 1)
        col = torch.cat([t[..., j].reshape(-1).to(I32) for t in tensors])
        if not lo <= g < hi:
            col = torch.zeros_like(col)
        return sharding_mod.reduce_i32(self.mesh, col, "sum")

    def reset_health(self) -> None:
        if self._health is not None:
            self._health = init_health(self._lcfg, self.device)

    # --- black-box forensics (requires SimConfig(blackbox=True)) ---

    def _bb_args(self) -> tuple:
        """The runners' trailing black-box argument: (BlackboxState,) when
        the black box is on, else ()."""
        return () if self._blackbox is None else (self._blackbox,)

    def _require_blackbox(self) -> BlackboxState:
        if self._blackbox is None:
            raise RuntimeError(
                "black box disabled; construct with SimConfig(blackbox=True)"
            )
        return self._blackbox

    def record_safety(self, viol: torch.Tensor) -> None:
        """Stamp a bool[kernels.N_SAFETY, G] violation mask onto the last
        stepped round's black-box record (kernels.blackbox_mark): the ad-hoc
        stepping path, where the caller audits each transition itself
        (kernels.check_safety_groups) and hands the mask back here."""
        bb = self._require_blackbox()
        (viol,) = self._block(viol)
        meta, trip = kernels.blackbox_mark(
            bb.meta, bb.trip_round, bb.round_idx, viol.to(self.device)
        )
        self._blackbox = bb._replace(meta=meta, trip_round=trip)

    def forensics(self) -> dict:
        """The fixed-size forensics capture as a plain dict: rounds_folded,
        and per safety slot how many groups have ever tripped it and the
        first-K offenders as [{"group": id, "round": first-trip round}, ...]
        (kernels.blackbox_capture; K = SimConfig.blackbox_topk).  The
        reduction runs on the device; only O(K) values cross to the host."""
        from . import sharding as sharding_mod

        bb = self._require_blackbox()
        k = min(self.cfg.blackbox_topk, self.cfg.n_groups)
        counts, ids, rounds = sharding_mod.blackbox_capture(self._lcfg, bb.trip_round, k)
        flat = torch.cat([counts, ids.flatten(), rounds.flatten()]).tolist()
        n = kernels.N_SAFETY
        ids_h = [flat[n + s * k:n + (s + 1) * k] for s in range(n)]
        rounds_h = [flat[n + n * k + s * k:n + n * k + (s + 1) * k] for s in range(n)]
        return {
            "rounds_folded": bb.round_idx,
            "counts": dict(zip(kernels.SAFETY_NAMES, flat[:n])),
            "offenders": {
                name: [
                    {"group": g, "round": r}
                    for g, r in zip(ids_h[s], rounds_h[s])
                    if g >= 0
                ]
                for s, name in enumerate(kernels.SAFETY_NAMES)
            },
        }

    def incident_report(self) -> dict:
        """The full incident JSON (forensics.build_incident): the capture
        plus each offender group's decoded ring window."""
        from . import forensics as forensics_mod

        return forensics_mod.build_incident(self)

    def reset_forensics(self) -> None:
        if self._blackbox is not None:
            self._blackbox = init_blackbox(self._lcfg, self.device)
            self._bb_seen = [0] * kernels.N_SAFETY
