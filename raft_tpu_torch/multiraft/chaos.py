"""Chaos scenarios: declarative fault plans compiled into per-phase schedules
on the device, and the runner that drives a whole plan through the
link-gated step.

Counterpart of `raft_tpu/multiraft/chaos.py` (all of it).  Its runner,
:func:`make_runner`, is a wrapper over `runner.make_runner`, which builds it
in `runner._make_chaos` as the reference's does (runner.py:131-205).

The fault surface is the pairwise link plane `link[P, P, G]` that
`sim.step(link=)` takes: a whole-peer crash isolates a peer's row and
column, an asymmetric partition is a directed subset, and per-link message
loss is a seeded per-round draw (`kernels.link_loss_draw`, keyed (round,
src, dst, group), so every run replays bit for bit).

A :class:`ChaosPlan` is a list of phases — partitions, directed link
overrides, loss rates, crashes, heals — each covering a round range and an
optional group selector.  :func:`compile_plan` lowers it into dense
per-phase schedule arrays, the bool and loss planes packed into 32-bit words
on the device as the reference packs them.  The runner then runs the
whole scenario: where the reference traces one jitted `lax.scan`, this
is a host loop over the rounds whose body queues device work only.  Each
round looks its phase up on the host (`phase_of_round` stays on the CPU,
so the lookup needs no device sync), gathers and unpacks that phase's
words, draws the loss sample, takes one link-gated step with the health
planes, and folds `kernels.check_safety` and :func:`update_chaos_stats`
(time to re-elect and MTTR off the HP_LEADERLESS plane) into two small
accumulators.  `health.HealthMonitor.chaos_report` formats them.

Plan JSON (tests/testdata/chaos/plans.json, examples/chaos/)::

    {"name": "split-brain", "peers": 5, "phases": [
        {"rounds": 30},                                   # settle
        {"rounds": 40, "partition": [[1, 2], [3, 4, 5]],  # symmetric split
         "append": 1},
        {"rounds": 20, "links": [{"from": 1, "to": 2, "up": false}],
         "loss": [{"from": 3, "to": 4, "rate": 0.5}],
         "crash": [5], "groups": {"mod": 2, "eq": 0}},
        {"rounds": 30, "heal": true}]}

:class:`HostSchedule` and :func:`host_loss_draw` are the numpy twins of the
device schedule, bit-identical to it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import kernels
from . import sim as sim_mod
from .kernels import LOSS_SCALE
from .platform import DeviceLike, resolve_device

I32 = torch.int32

# Group selectors: "all", an explicit id list, or {"mod": m, "eq": r}.
GroupSel = Union[str, Sequence[int], Dict[str, int]]


@dataclass
class ChaosPhase:
    """One contiguous stretch of rounds with a fixed fault topology.

    rounds:    phase length in protocol rounds (>= 1).
    partition: list of peer-id cells; links BETWEEN cells are down, links
               within a cell stay up.  Peers in no cell form one implicit
               extra cell.  None = no partition.
    links:     directed overrides [{"from": a, "to": b, "up": bool}],
               applied after the partition.
    loss:      directed loss rates [{"from": a, "to": b, "rate": 0..1}];
               "rate" is sampled per (round, link, group).
    loss_all:  uniform loss rate applied to every directed link first.
    crash:     peer ids crashed (fully isolated) for the phase.
    groups:    which groups the phase's faults apply to; non-selected
               groups run fault-free for the phase.
    append:    per-round append workload proposed at each group's leader.
    """

    rounds: int
    partition: Optional[List[List[int]]] = None
    links: List[Dict[str, object]] = field(default_factory=list)
    loss: List[Dict[str, object]] = field(default_factory=list)
    loss_all: float = 0.0
    crash: List[int] = field(default_factory=list)
    groups: GroupSel = "all"
    append: int = 0


@dataclass
class ChaosPlan:
    """A named multi-phase fault scenario (host-side, declarative)."""

    name: str
    n_peers: int
    phases: List[ChaosPhase]

    @property
    def n_rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)


def plan_from_dict(doc: Dict[str, object]) -> ChaosPlan:
    """Build a ChaosPlan from its JSON document form (see module doc)."""
    phases: List[ChaosPhase] = []
    for ph in doc["phases"]:  # type: ignore[index]
        if not isinstance(ph, dict):
            raise ValueError(f"phase is not an object: {ph!r}")
        if ph.get("heal"):
            ph = {"rounds": ph["rounds"], "append": ph.get("append", 0)}
        phases.append(
            ChaosPhase(
                rounds=int(ph["rounds"]),
                partition=ph.get("partition"),
                links=list(ph.get("links", [])),
                loss=list(ph.get("loss", [])),
                loss_all=float(ph.get("loss_all", 0.0)),
                crash=[int(p) for p in ph.get("crash", [])],
                groups=ph.get("groups", "all"),
                append=int(ph.get("append", 0)),
            )
        )
    return ChaosPlan(
        name=str(doc.get("name", "unnamed")),
        n_peers=int(doc["peers"]),  # type: ignore[arg-type]
        phases=phases,
    )


def load_plan(path: str) -> ChaosPlan:
    """Load a ChaosPlan from a JSON file (the bench.py --chaos input)."""
    with open(path, "r", encoding="utf-8") as f:
        return plan_from_dict(json.load(f))


def _group_mask(sel: GroupSel, n_groups: int) -> np.ndarray:
    if isinstance(sel, str):
        if sel != "all":
            raise ValueError(f"unknown group selector {sel!r}")
        return np.ones(n_groups, dtype=bool)
    if isinstance(sel, dict):
        m, r = int(sel["mod"]), int(sel["eq"])
        return (np.arange(n_groups) % m) == r
    mask = np.zeros(n_groups, dtype=bool)
    for g in sel:
        if not 0 <= int(g) < n_groups:
            raise ValueError(f"group id {g} out of range [0, {n_groups})")
        mask[int(g)] = True
    return mask


def _peer_index(pid: object, n_peers: int, what: str, phase: int) -> int:
    """Validate a 1-based peer id from a plan document -> 0-based index (a 0
    or negative id would otherwise wrap into the wrong peer's link row)."""
    p = int(pid)  # type: ignore[call-overload]
    if not 1 <= p <= n_peers:
        raise ValueError(
            f"phase {phase}: {what} peer id {p} out of range [1, {n_peers}]"
        )
    return p - 1


def _rate_to_fp(rate: float) -> int:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"loss rate {rate} outside [0, 1]")
    return int(round(rate * LOSS_SCALE))


class CompiledChaos(NamedTuple):
    """Schedule arrays for one plan at one batch shape.

    The bool and loss planes are packed (kernels.pack_bits and
    pack_u16_pairs) into 32-bit words, int32 tensors holding the
    reference's uint32 bit patterns, on the device; schedule_masks unpacks
    one phase a round.  `phase_of_round` stays on the CPU: the round loop
    is a host loop, and looking the phase up there costs no device sync.

    phase_of_round: int32[R] (CPU)          round -> phase index
    link_packed:    int32[NPH, Wl, G]       per-phase base link plane, bit
                                            (s*P + d) of the word stack
                                            (Wl = ceil(P*P/32))
    loss_packed:    int32[NPH, Wr, G]       per-phase loss rates, two
                                            halfwords a word (Wr =
                                            ceil(P*P/2))
    crashed_packed: int32[NPH, 1, G]        per-phase crash masks, bit p
    append:         int32[NPH, G]           per-phase append workload
    n_peers:        the unpack shape
    """

    phase_of_round: torch.Tensor
    link_packed: torch.Tensor
    loss_packed: torch.Tensor
    crashed_packed: torch.Tensor
    append: torch.Tensor
    n_peers: int

    @property
    def n_rounds(self) -> int:
        return int(self.phase_of_round.shape[0])


def _compile_arrays(
    plan: ChaosPlan, n_groups: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The numpy schedule (shared by the device path and HostSchedule)."""
    P, G = plan.n_peers, n_groups
    nph = len(plan.phases)
    if nph == 0:
        raise ValueError("plan has no phases")
    phase_of_round = np.zeros(plan.n_rounds, dtype=np.int32)
    link = np.ones((nph, P, P, G), dtype=bool)
    loss = np.zeros((nph, P, P, G), dtype=np.int32)
    crashed = np.zeros((nph, P, G), dtype=bool)
    append = np.zeros((nph, G), dtype=np.int32)
    r0 = 0
    for i, ph in enumerate(plan.phases):
        if ph.rounds < 1:
            raise ValueError(f"phase {i}: rounds must be >= 1")
        phase_of_round[r0 : r0 + ph.rounds] = i
        r0 += ph.rounds
        gsel = _group_mask(ph.groups, G)
        lk = np.ones((P, P), dtype=bool)
        if ph.partition is not None:
            cell = np.full(P, -1, dtype=np.int64)
            for c, ids in enumerate(ph.partition):
                for pid in ids:
                    cell[_peer_index(pid, P, "partition", i)] = c
            cell[cell < 0] = len(ph.partition)  # implicit last cell
            lk = cell[:, None] == cell[None, :]
        for ov in ph.links:
            a = _peer_index(ov["from"], P, "link", i)
            b = _peer_index(ov["to"], P, "link", i)
            lk[a, b] = bool(ov.get("up", False))
        ls = np.full((P, P), _rate_to_fp(ph.loss_all), dtype=np.int32)
        for ov in ph.loss:
            a = _peer_index(ov["from"], P, "loss", i)
            b = _peer_index(ov["to"], P, "loss", i)
            ls[a, b] = _rate_to_fp(float(ov["rate"]))  # type: ignore[arg-type]
        link[i] = np.where(gsel[None, None, :], lk[:, :, None], True)
        loss[i] = np.where(gsel[None, None, :], ls[:, :, None], 0)
        for pid in ph.crash:
            crashed[i, _peer_index(pid, P, "crash", i)] = gsel
        append[i] = np.where(gsel, ph.append, 0)
    # The chaos-stats accumulator sums per-group indicators over the run in
    # int32; bound the schedule so it cannot wrap (this also keeps every
    # round index, the loss draw's key, in int32).
    if plan.n_rounds * max(1, G) >= 2**31:
        raise ValueError(
            f"plan spans {plan.n_rounds} rounds x {G} groups >= 2**31 "
            "(group, round) pairs; the int32 chaos-stats accumulator "
            "could wrap — split the plan"
        )
    return phase_of_round, link, loss, crashed, append


def compile_plan(
    plan: ChaosPlan, n_groups: int, device: DeviceLike = None
) -> CompiledChaos:
    """Lower a ChaosPlan to schedule arrays for `n_groups` groups, the
    packed words on `cuda` unless `device` says otherwise (see
    CompiledChaos)."""
    dev = resolve_device(device)
    phase_of_round, link, loss, crashed, append = _compile_arrays(plan, n_groups)
    P, G = plan.n_peers, n_groups
    nph = link.shape[0]

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    def along_planes(pack, planes):  # pack axis 1 of [NPH, K, G]
        return pack(planes.transpose(0, 1)).transpose(0, 1).contiguous()

    return CompiledChaos(
        phase_of_round=torch.from_numpy(phase_of_round),
        link_packed=along_planes(
            kernels.pack_bits, on_dev(link).reshape(nph, P * P, G)
        ),
        loss_packed=along_planes(
            kernels.pack_u16_pairs, on_dev(loss).reshape(nph, P * P, G)
        ),
        crashed_packed=along_planes(kernels.pack_bits, on_dev(crashed)),
        append=on_dev(append),
        n_peers=P,
    )


def schedule_planes(
    compiled: CompiledChaos, round_idx: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(base_link bool[P, P, G], loss_rate int32[P, P, G], crashed bool[P,
    G], append int32[G]) for one round: the round's phase row gathered and
    unpacked, without the loss sample knocked out."""
    P = compiled.n_peers
    G = compiled.append.shape[1]
    ph = int(compiled.phase_of_round[round_idx])
    link = kernels.unpack_bits(compiled.link_packed[ph], P * P).reshape(P, P, G)
    loss = kernels.unpack_u16_pairs(compiled.loss_packed[ph], P * P).reshape(P, P, G)
    crashed = kernels.unpack_bits(compiled.crashed_packed[ph], P)
    return link, loss, crashed, compiled.append[ph]


def schedule_masks(
    compiled: CompiledChaos, round_idx: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(link, crashed, append) for one round of the schedule: the phase's
    words unpacked on their device, the seeded loss sample knocked out."""
    link, loss, crashed, append = schedule_planes(compiled, round_idx)
    drop = kernels.link_loss_draw(round_idx, loss)
    return link & ~drop, crashed, append


# --- host twins (bit-identical to the device schedule) --------------------


def host_loss_draw(round_idx: int, loss_rate: np.ndarray) -> np.ndarray:
    """Numpy twin of kernels.link_loss_draw (the same counter PRNG and key
    layout, in numpy's uint32)."""
    P = loss_rate.shape[0]
    G = loss_rate.shape[2]
    g = np.arange(G, dtype=np.uint32)[None, None, :]
    s = np.arange(P, dtype=np.uint32)[:, None, None]
    d = np.arange(P, dtype=np.uint32)[None, :, None]
    lane = s * np.uint32(P) + d + np.uint32(1)

    def mix(x: np.ndarray) -> np.ndarray:
        x = x.astype(np.uint32)
        x ^= x >> np.uint32(16)
        x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x ^= x >> np.uint32(13)
        x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
        x ^= x >> np.uint32(16)
        return x

    x = mix((g * np.uint32(0x9E3779B1) + np.uint32(round_idx)).astype(np.uint32))
    x = mix(x ^ (lane * np.uint32(0x85EBCA6B)).astype(np.uint32))
    return (x % np.uint32(LOSS_SCALE)).astype(np.int32) < loss_rate


class HostSchedule:
    """The compiled schedule kept in numpy.  Round r's masks are exactly
    what schedule_masks gives the device step: the base link plane of the
    round's phase minus the seeded loss sample, the phase's crash mask and
    its append workload."""

    def __init__(self, plan: ChaosPlan, n_groups: int):
        (
            self.phase_of_round,
            self.link,
            self.loss,
            self.crashed,
            self.append,
        ) = _compile_arrays(plan, n_groups)
        self.n_rounds = plan.n_rounds
        self.n_peers = plan.n_peers
        self.n_groups = n_groups

    def masks(self, round_idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(link[P, P, G], crashed[P, G], append[G]) for one round."""
        ph = int(self.phase_of_round[round_idx])
        drop = host_loss_draw(round_idx, self.loss[ph])
        return self.link[ph] & ~drop, self.crashed[ph], self.append[ph]


# --- the scenario runner ----------------------------------------------------

# Chaos-stats accumulator indices ([N_CHAOS_STATS] int32; time to re-elect
# and MTTR off the health planes — HealthMonitor.chaos_report formats them).
CS_REELECTIONS = 0  # leaderless episodes that ended (leader regained)
CS_HEALED_ROUNDS = 1  # summed length of ended episodes (MTTR numerator)
CS_MAX_STREAK = 2  # longest leaderless streak observed anywhere
CS_LEADERLESS_ROUNDS = 3  # total leaderless (group, round) pairs
N_CHAOS_STATS = 4

CHAOS_STAT_NAMES = (
    "reelections",
    "healed_rounds",
    "max_leaderless_streak",
    "leaderless_group_rounds",
)


def update_chaos_stats(
    stats: torch.Tensor,  # int32[N_CHAOS_STATS]
    prev_leaderless: torch.Tensor,  # int32[G]
    new_leaderless: torch.Tensor,  # int32[G]
) -> torch.Tensor:
    """Fold one round's leaderless-plane transition into the stats (a fresh
    int32 vector; every sum is int32)."""
    healed = (prev_leaderless > 0) & (new_leaderless == 0)
    return torch.stack([
        stats[CS_REELECTIONS] + healed.sum(dtype=I32),
        stats[CS_HEALED_ROUNDS]
        + torch.where(healed, prev_leaderless, 0).sum(dtype=I32),
        torch.maximum(stats[CS_MAX_STREAK], new_leaderless.amax()),
        stats[CS_LEADERLESS_ROUNDS] + (new_leaderless > 0).sum(dtype=I32),
    ])


def make_runner(cfg: sim_mod.SimConfig, compiled: CompiledChaos):
    """The whole-scenario runner: fn(state, health) -> (state', health',
    stats int32[N_CHAOS_STATS], safety int32[N_SAFETY]), every round of the
    compiled schedule in order, on the device of `compiled`.  Each round:
    the schedule's masks, one sim.step with the link plane and the health
    planes, check_safety against the round's starting commit, and the
    chaos-stats fold.  The loop queues device work only; nothing crosses to
    the host until the caller reads the results.

    With SimConfig(blackbox=True) it is fn(state, health, blackbox) ->
    (state', health', blackbox', stats, safety): each round audits with
    kernels.check_safety_groups instead, whose per-slot sums are the safety
    counts, and folds the audit and the round's record into the black box
    in one kernels.blackbox_fold."""
    from . import runner as runner_mod

    return runner_mod.make_runner(cfg, (compiled,))


def run_plan(
    cfg: sim_mod.SimConfig,
    state: sim_mod.SimState,
    compiled: CompiledChaos,
    health: Optional[sim_mod.HealthState] = None,
    device: DeviceLike = None,
):
    """Execute a whole compiled scenario: (state', health', stats, safety),
    all on the device.  The health planes are required (the stats ride on
    HP_LEADERLESS): pass a HealthState to continue its windows, or None to
    start fresh.  Runs on `cuda` unless `device` says otherwise; the state
    and the schedule must lie there."""
    dev = resolve_device(device)
    for name, t in (("state", state.term), ("schedule", compiled.append)):
        if t.device.type != dev.type:
            raise ValueError(f"run_plan on {dev}: the {name} lies on {t.device}")
    if health is None:
        health = sim_mod.init_health(cfg, state.term.device)
    return make_runner(cfg, compiled)(state, health)
