"""Compiled client workloads: Zipf-skewed read/write mixes driven through the
batched step.

Counterpart of `raft_tpu/multiraft/workload.py` (all of it).  Its two
runners, :func:`make_runner` and :func:`make_split_runner`, are wrappers
over `runner.make_runner`, which builds them in `runner._make_workload`
and `_make_workload_split` as the reference's runner.py does (:493-783);
the split runner refuses a black-box config as the reference's does.

A :class:`ClientPlan` is a list of phases, each covering a round range and
a group selector, with the phase's write load (a uniform `append`, or a
seeded Zipf draw per group: the hot-region skew) and its read traffic (a
read every `read_every` rounds per selected group, in `read_mode` "safe",
the ReadIndex quorum round, or "lease", the LeaseBased local serve under
the check-quorum leader lease).  :func:`compile_plan` lowers it on the host
into dense schedule arrays, the per-round read-fire masks packed 32:1 along
the group axis (kernels.pack_bits_g).

Each round of a runner: outstanding reads retry through
`sim.step(read_propose=)` (one read in flight a group; a fire landing on an
outstanding read is dropped and counted), a served read folds its latency
in rounds into a histogram on the device (N_LAT_BUCKETS buckets, the last
one capped), and `kernels.check_safety`'s linearizability slots
(SV_STALE_READ, SV_DUAL_LEASE) audit the lease-holder mask every round
(`reconfig._runner_body` is the shared round body).  The histogram reduces
on the device to p50/p90/p99 (:func:`latency_percentiles`, the nearest-rank
rule), so only a fixed-size report crosses to the host.

Where the reference traces one jitted `lax.scan`, :func:`make_runner` is a
host loop over the rounds that adds no host sync of its own, and
:func:`make_split_runner` turns each k-round block's `lax.cond` into one
host `bool()`.

Plan JSON (examples/reads/)::

    {"name": "zipf-mixed", "peers": 5, "seed": 7, "phases": [
        {"rounds": 64, "append": 1},                       # settle, no reads
        {"rounds": 128, "write_zipf": 1.8, "write_max": 8,
         "read_every": 2, "read_mode": "lease"},
        {"rounds": 64, "read_every": 1, "read_mode": "safe",
         "groups": {"mod": 2, "eq": 0}}]}

:class:`HostClientSchedule` is the numpy twin of the device schedule, built
by the same `_compile_arrays` walk.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import chaos as chaos_mod
from . import kernels
from . import reconfig as reconfig_mod
from . import sim as sim_mod
from .chaos import GroupSel, _group_mask
from .platform import DeviceLike, resolve_device

I32 = torch.int32

_MODE_CODES = {"safe": sim_mod.READ_SAFE, "lease": sim_mod.READ_LEASE}

# Read-stats accumulator indices ([N_READ_STATS] int32; each slot grows by
# at most G a round, and compile_plan bounds rounds x G < 2**31).
RS_ISSUED = 0  # fresh reads accepted (fires finding no outstanding read)
RS_SERVED_LEASE = 1  # reads served locally under the lease gate
RS_SERVED_QUORUM = 2  # reads served through the ReadIndex quorum round
RS_DEGRADED_SERVES = 3  # lease requests that served via the fallback
RS_RETRY_ROUNDS = 4  # (group, round) pairs an outstanding read waited
RS_DROPPED_FIRES = 5  # fires dropped because a read was already in flight
N_READ_STATS = 6

READ_STAT_NAMES = (
    "reads_issued",
    "served_lease",
    "served_quorum",
    "degraded_serves",
    "retry_group_rounds",
    "dropped_fires",
)

# Latency histogram: bucket i counts reads served i rounds after issue; the
# last bucket takes every latency >= LAT_CAP.  int32 counts, bounded by the
# same rounds x G < 2**31 check.
LAT_CAP = 64
N_LAT_BUCKETS = LAT_CAP + 1


@dataclass
class ClientPhase:
    """One contiguous stretch of rounds with a fixed client traffic mix.

    rounds:     phase length in protocol rounds (>= 1).
    append:     uniform per-round write load at each selected group's
                leader (ignored when write_zipf > 0).
    write_zipf: Zipf skew parameter (> 1); when set, each selected group
                draws its per-round write load once for the phase from
                numpy's zipf(a), clipped to write_max.
    write_max:  clip bound for the Zipf draw.
    read_every: issue a read every N rounds per selected group (0 = no
                reads this phase).
    read_mode:  "safe" (ReadIndex quorum round) or "lease" (LeaseBased
                local serve; degrades to safe where the gate fails).
    stagger:    offset each group's fire cadence by its group id, so the
                fleet's reads spread across rounds (the default), instead of
                firing in lockstep.
    groups:     which groups the phase's traffic applies to.
    """

    rounds: int
    append: int = 0
    write_zipf: float = 0.0
    write_max: int = 8
    read_every: int = 0
    read_mode: str = "safe"
    stagger: bool = True
    groups: GroupSel = "all"


@dataclass
class ClientPlan:
    """A named multi-phase client workload (host-side, declarative)."""

    name: str
    n_peers: int
    phases: List[ClientPhase] = field(default_factory=list)
    seed: int = 0

    @property
    def n_rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)


def plan_from_dict(doc: Dict[str, object]) -> ClientPlan:
    """Build a ClientPlan from its JSON document form (see module doc)."""
    phases: List[ClientPhase] = []
    for i, ph in enumerate(doc["phases"]):  # type: ignore[index]
        if not isinstance(ph, dict):
            raise ValueError(f"phase {i} is not an object: {ph!r}")
        mode = str(ph.get("read_mode", "safe"))
        if mode not in _MODE_CODES:
            raise ValueError(
                f"phase {i}: read_mode {mode!r} is not one of "
                f"{sorted(_MODE_CODES)}"
            )
        phases.append(
            ClientPhase(
                rounds=int(ph["rounds"]),
                append=int(ph.get("append", 0)),
                write_zipf=float(ph.get("write_zipf", 0.0)),
                write_max=int(ph.get("write_max", 8)),
                read_every=int(ph.get("read_every", 0)),
                read_mode=mode,
                stagger=bool(ph.get("stagger", True)),
                groups=ph.get("groups", "all"),
            )
        )
    return ClientPlan(
        name=str(doc.get("name", "unnamed")),
        n_peers=int(doc["peers"]),  # type: ignore[arg-type]
        phases=phases,
        seed=int(doc.get("seed", 0)),  # type: ignore[arg-type]
    )


def load_plan(path: str) -> ClientPlan:
    """Load a ClientPlan from a JSON file (the bench.py --reads input)."""
    with open(path, "r", encoding="utf-8") as f:
        return plan_from_dict(json.load(f))


class CompiledClient(NamedTuple):
    """Schedule arrays for one client plan at one batch shape.
    `phase_of_round` stays on the CPU (the round loop is a host loop, and
    looking a phase up there costs no device sync); the rest lie on the
    device.

    phase_of_round:   int32[R] (CPU)  round -> phase index
    read_fire_packed: int32[R, Wg]    per-round read-issue mask packed 32:1
                                      along the group axis
                                      (kernels.pack_bits_g; Wg =
                                      ceil(G/32)), the reference's uint32
                                      bits
    read_mode:        int32[NPH, G]   sim.READ_* code per phase (0 where
                                      the phase reads nothing)
    append:           int32[NPH, G]   per-phase per-group write load (the
                                      seeded Zipf draw baked in)
    n_peers:          the peer count
    """

    phase_of_round: torch.Tensor
    read_fire_packed: torch.Tensor
    read_mode: torch.Tensor
    append: torch.Tensor
    n_peers: int

    @property
    def n_rounds(self) -> int:
        return int(self.phase_of_round.shape[0])


def _compile_arrays(plan: ClientPlan, n_groups: int):
    """The numpy schedule, shared by the device schedule and
    HostClientSchedule.  The Zipf write draws come from one
    RandomState(plan.seed) consumed in phase order, G values at a time."""
    G = n_groups
    nph = len(plan.phases)
    if nph == 0:
        raise ValueError("plan has no phases")
    R = plan.n_rounds
    phase_of_round = np.zeros(R, dtype=np.int32)
    read_fire = np.zeros((R, G), dtype=bool)
    read_mode = np.zeros((nph, G), dtype=np.int32)
    append = np.zeros((nph, G), dtype=np.int32)
    rng = np.random.RandomState(plan.seed)
    gid = np.arange(G)
    r0 = 0
    for i, ph in enumerate(plan.phases):
        if ph.rounds < 1:
            raise ValueError(f"phase {i}: rounds must be >= 1")
        phase_of_round[r0 : r0 + ph.rounds] = i
        gsel = _group_mask(ph.groups, G)
        if ph.write_zipf > 0.0:
            if ph.write_zipf <= 1.0:
                raise ValueError(
                    f"phase {i}: write_zipf must be > 1 (numpy zipf)"
                )
            draws = np.minimum(
                rng.zipf(ph.write_zipf, size=G), ph.write_max
            ).astype(np.int32)
        else:
            draws = np.full(G, ph.append, dtype=np.int32)
        append[i] = np.where(gsel, draws, 0)
        if ph.read_every > 0:
            read_mode[i] = np.where(gsel, _MODE_CODES[ph.read_mode], 0)
            off = gid % ph.read_every if ph.stagger else np.zeros(G, int)
            for o in range(ph.rounds):
                read_fire[r0 + o] = gsel & ((o + off) % ph.read_every == 0)
        r0 += ph.rounds
    # The read stats and the latency histogram sum per-group indicators
    # over the run in int32; bound the schedule so they cannot wrap.
    if R * max(1, G) >= 2**31:
        raise ValueError(
            f"plan spans {R} rounds x {G} groups >= 2**31 (group, round) "
            "pairs; the int32 read-stats/latency accumulators could wrap "
            "— split the plan"
        )
    return phase_of_round, read_fire, read_mode, append


def compile_plan(
    plan: ClientPlan, n_groups: int, device: DeviceLike = None
) -> CompiledClient:
    """Lower a ClientPlan to schedule arrays for `n_groups` groups on `cuda`
    unless `device` says otherwise (fire masks packed along G, see
    CompiledClient)."""
    dev = resolve_device(device)
    phase_of_round, read_fire, read_mode, append = _compile_arrays(plan, n_groups)
    return CompiledClient(
        phase_of_round=torch.from_numpy(phase_of_round),
        read_fire_packed=kernels.pack_bits_g(torch.from_numpy(read_fire).to(dev)),
        read_mode=torch.from_numpy(read_mode).to(dev),
        append=torch.from_numpy(append).to(dev),
        n_peers=plan.n_peers,
    )


class HostClientSchedule:
    """The compiled client schedule kept in numpy: round r's traffic is
    exactly what the runner's round body gathers (the round's fire row, the
    phase's mode row and the phase's append row)."""

    def __init__(self, plan: ClientPlan, n_groups: int):
        (
            self.phase_of_round,
            self.read_fire,
            self.read_mode,
            self.append,
        ) = _compile_arrays(plan, n_groups)
        self.n_rounds = plan.n_rounds
        self.n_peers = plan.n_peers
        self.n_groups = n_groups

    def masks(self, round_idx: int):
        """(fire[G] bool, mode[G] int32, append[G] int32) for one round."""
        ph = int(self.phase_of_round[round_idx])
        return (
            self.read_fire[round_idx],
            self.read_mode[ph],
            self.append[ph],
        )


class ReadCarry(NamedTuple):
    """The runners' per-group outstanding-read carry: `pending_mode` is the
    sim.READ_* code of the read in flight (0 = none: one read a group at a
    time, new fires drop), `pending_since` the absolute round it was issued
    (latency = serve round - pending_since)."""

    pending_mode: torch.Tensor  # int32[G]
    pending_since: torch.Tensor  # int32[G]


def init_read_carry(n_groups: int, device: DeviceLike = None) -> ReadCarry:
    """A carry with no read outstanding, on `cuda` unless `device` says
    otherwise."""
    dev = resolve_device(device)
    return ReadCarry(
        pending_mode=torch.zeros((n_groups,), dtype=I32, device=dev),
        pending_since=torch.zeros((n_groups,), dtype=I32, device=dev),
    )


def latency_percentiles(
    hist: torch.Tensor,  # int32[L]
    qs: Tuple[int, ...] = (50, 90, 99),
) -> torch.Tensor:
    """Nearest-rank percentiles of the latency histogram on its device: the
    smallest bucket with at least ceil(q/100 * N) of the N served reads at
    or below it (host_latency_percentile's rule over the histogram).
    Returns int32[len(qs)], -1 everywhere when no read was served.  The rank
    arithmetic splits n = 100a + b, so a*q + ceil(b*q/100) stays in int32
    (n < 2**31 by compile_plan's bound, q <= 100)."""
    n = hist.sum(dtype=I32)
    cum = torch.cumsum(hist, 0, dtype=I32)
    out = []
    for q in qs:
        a, b = n // 100, n % 100
        rank = a * q + (b * q + 99) // 100
        idx = (cum < rank).sum(dtype=I32)
        out.append(torch.where(n == 0, -1, idx))
    return torch.stack(out)


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (the smallest sample with at least q of the
    distribution at or below it): xs sorted, 0 < q <= 1.  The reference's
    profiling.RoundTimer._percentile."""
    return xs[math.ceil(q * len(xs)) - 1]


def host_latency_percentile(samples, q: int) -> int:
    """The host twin of latency_percentiles over a raw latency sample list
    (-1 when it is empty)."""
    xs = sorted(samples)
    if not xs:
        return -1
    return _percentile(xs, q / 100)


def _validate(cfg, client, chaos_compiled, reconfig_compiled):
    if client.n_peers != cfg.n_peers:
        raise ValueError(
            f"client plan is for {client.n_peers} peers but the sim has "
            f"{cfg.n_peers}"
        )
    if client.append.shape[1] != cfg.n_groups:
        raise ValueError(
            f"the client schedule is compiled for {client.append.shape[1]} "
            f"groups, the config has {cfg.n_groups}"
        )
    R = client.n_rounds
    if chaos_compiled is not None and chaos_compiled.n_rounds != R:
        raise ValueError(
            f"chaos schedule spans {chaos_compiled.n_rounds} rounds but "
            f"the client plan spans {R} — compose equal-length plans"
        )
    if reconfig_compiled is not None and reconfig_compiled.n_rounds != R:
        raise ValueError(
            f"reconfig schedule spans {reconfig_compiled.n_rounds} rounds "
            f"but the client plan spans {R} — compose equal-length plans"
        )


def _zero_read_accumulators(dev):
    return (
        torch.zeros((N_READ_STATS,), dtype=I32, device=dev),
        torch.zeros((N_LAT_BUCKETS,), dtype=I32, device=dev),
    )


def _check_device(st, hl, rcar, dev):
    reconfig_mod._check_device(st, hl, dev)
    if rcar.pending_mode.device != dev:
        raise ValueError(
            f"the read carry must lie on the schedule's device {dev}, got "
            f"{rcar.pending_mode.device}"
        )


def make_runner(
    cfg: sim_mod.SimConfig,
    client: CompiledClient,
    chaos_compiled: Optional[chaos_mod.CompiledChaos] = None,
    reconfig_compiled: Optional[reconfig_mod.CompiledReconfig] = None,
):
    """The whole-scenario client-workload runner: every round of the
    schedule through reconfig._runner_body with the read protocol threaded
    (read fires, retries and serves, the Zipf write skew, the latency fold,
    the MTTR stats and the full safety audit with the linearizability
    slots), then the reconfig runner's tail audit; optionally composed with
    a chaos schedule and a reconfig schedule of equal length (a missing
    reconfig plan runs the no-op schedule, autopilot.empty_reconfig_schedule,
    whose op protocol never moves).

    Returns runner(state, health, rstate, read_carry) -> (state', health',
    rstate', stats int32[N_CHAOS_STATS], rstats int32[N_RECONFIG_STATS],
    safety int32[N_SAFETY], read_carry', read_stats int32[N_READ_STATS],
    lat_hist int32[N_LAT_BUCKETS]).  The loop adds no host sync of its own;
    the results stay on the schedule's device.  With
    SimConfig(blackbox=True) the runner takes the BlackboxState last and
    returns it last (reconfig._runner_body's black-box arm)."""
    from . import runner as runner_mod

    return runner_mod.make_runner(cfg, (client, chaos_compiled, reconfig_compiled))


def make_split_runner(
    cfg: sim_mod.SimConfig,
    client: CompiledClient,
    k: int = 8,
    chaos_compiled=None,
    reconfig_compiled=None,
):
    """The fused client-workload runner: make_runner's protocol and
    accounting, with the same end state, health planes, read carry, read
    stats, latency histogram and safety accumulators, run as k-round blocks
    (a general tail after the last whole block).

    A block runs the fused kernel (fused_step.steady_round(cfg, k,
    with_health=True); the damped kernel for a damped config) when, over
    the whole batch, the steady invariant holds for the horizon
    (fused_step.steady_mask with `read_pending=reads_pending_in_horizon`:
    an outstanding read of any mode, or a scheduled Safe fire, rejects),
    every scheduled lease fire is provably servable (the acting leader
    passes the lease gate at block entry, and heartbeat_tick == 1 keeps its
    recent_active row saturated every round) and the block lies in one
    client phase; one host bool() a block, where the reference's lax.cond
    picks.  Else it runs k general rounds.  The fused arm folds the lease
    receipts in closed form: each fire issues and serves the round it
    fires (latency 0), the read carry stays empty, and every safety slot
    stays zero.

    Only bare plans: composing a chaos or reconfig schedule raises (use
    make_runner).  Returns runner(st, hl, rst, rcar) -> make_runner's nine
    results and `fused_rounds`, a Python int of fused group-rounds (k x
    n_groups per fused block).  `runner.blocks` lists the last call's
    blocks as (first round, fused) pairs."""
    from . import runner as runner_mod

    return runner_mod.make_runner(
        cfg, (client, chaos_compiled, reconfig_compiled), split=True, k=k
    )


def unpack_fires(words: torch.Tensor, n_groups: int, cfg=None) -> torch.Tensor:
    """The read-fire words `words` (int32[..., Wg]) of `n_groups` groups
    unpacked to bool[..., n_groups].  On a rank of a mesh run (cfg.shard
    set) whose words were replicated, not sharded (sharding.shard_client:
    the word axis did not tile the mesh), the words are the whole batch's
    and the rank takes its own block of the unpacked bits."""
    sh = None if cfg is None else cfg.shard
    if sh is not None and words.shape[-1] == -(-sh.n_groups // 32):
        return kernels.unpack_bits_g(words, sh.n_groups)[..., sh.lo:sh.hi]
    return kernels.unpack_bits_g(words, n_groups)


def _mode_fires(client: CompiledClient, r0: int, horizon: int, code: int,
                cfg=None):
    """int32[G]: the scheduled fires of read mode `code` per group in
    rounds [r0, r0 + horizon) that lie inside the plan (r0 >= 0); `cfg`
    as unpack_fires'."""
    G = client.read_mode.shape[1]
    phases = client.phase_of_round
    n = torch.zeros((G,), dtype=I32, device=client.read_mode.device)
    r, end = r0, min(r0 + horizon, client.n_rounds)
    while r < end:
        # One launch group per stretch of one phase (one mode row).
        ph = int(phases[r])
        e = r + 1
        while e < end and int(phases[e]) == ph:
            e += 1
        fires = unpack_fires(client.read_fire_packed[r:e], G, cfg)
        n = n + torch.where(client.read_mode[ph] == code,
                            fires.sum(0, dtype=I32), 0)
        r = e
    return n


def reads_pending_in_horizon(
    client: CompiledClient,
    rcar: ReadCarry,
    r0: int,
    horizon: int,
    cfg=None,
) -> torch.Tensor:
    """bool[G]: the group has quorum-round read work inside [r0, r0 +
    horizon): an outstanding read (any mode: it retries every round) or a
    scheduled Safe-mode fire.  This is the fused horizon's read rejection
    mask (fused_step.steady_mask's `read_pending=`); pure lease fires are
    not pending, since on a steady horizon the lease gate holds and the
    serve touches no message plane."""
    safe = _mode_fires(client, r0, horizon, sim_mod.READ_SAFE, cfg)
    return (rcar.pending_mode > 0) | (safe > 0)


def lease_fires_in_block(
    client: CompiledClient,
    r0: int,
    horizon: int,
    cfg=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_lease int32[G], any bool[G]): the scheduled lease-mode fires per
    group inside [r0, r0 + horizon), the closed-form serve count a fused
    block folds into the latency histogram's zero bucket."""
    n = _mode_fires(client, r0, horizon, sim_mod.READ_LEASE, cfg)
    return n, n > 0


def read_report(rdstats, lat_p, safety, stats, rounds: int) -> dict:
    """The per-scenario read-workload summary off the accumulators (host
    sequences of ints): what bench.py --reads and ClusterSim.run_reads
    emit.  `lat_p` is latency_percentiles' (p50, p90, p99)."""
    from .chaos import CS_HEALED_ROUNDS, CS_MAX_STREAK, CS_REELECTIONS
    from .kernels import SAFETY_NAMES

    reelections = int(stats[CS_REELECTIONS])
    healed = int(stats[CS_HEALED_ROUNDS])
    return {
        "rounds": int(rounds),
        **{name: int(v) for name, v in zip(READ_STAT_NAMES, rdstats)},
        "read_p50": int(lat_p[0]),
        "read_p90": int(lat_p[1]),
        "read_p99": int(lat_p[2]),
        "mttr_rounds": (
            round(healed / reelections, 3) if reelections else None
        ),
        "reelections": reelections,
        "max_leaderless_streak": int(stats[CS_MAX_STREAK]),
        "safety": {
            name: int(v) for name, v in zip(SAFETY_NAMES, safety)
        },
    }
