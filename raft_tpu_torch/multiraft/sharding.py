"""Multi-GPU scale-out: the group axis split over ranks of a process group.

Counterpart of `raft_tpu/multiraft/sharding.py` (all of it).  The
reference is single-controller SPMD: one process drives a device mesh, jit
sees global shapes, and XLA splits every [.., G] plane into contiguous
equal blocks along G in device order.  PyTorch's idiom for the same layout
is one process per device in a `torch.distributed` process group, so here:

  * rank r of an N-rank `Mesh` owns the contiguous groups [r·G/N,
    (r+1)·G/N), the reference's block layout; G must tile the mesh, as the
    reference's placement requires;
  * every rank takes the same global inputs and keeps its own block
    (`shard_state`, `shard_chaos`, ... and `ClusterSim(mesh=)`'s
    placement), so the same caller code runs unchanged on every rank;
  * a rank's planes carry a local config (`local_config`, a
    sim.ShardConfig: n_groups the block width, `shard` the rank's
    `sim.GroupShard`), whose group-keyed
    draws (the timeout PRNG, the per-link loss, the fused kernels'
    `group_base`) key on the GLOBAL ids, as the reference's global iota
    does, so the sharded run is bit-identical to the unsharded one;
  * every cross-rank reduction lives in this module: an `all_reduce` (SUM,
    MIN or MAX) of a fixed-size int32 buffer.  A gather is an all_reduce
    SUM of a zeroed global buffer in which each rank fills its own block
    (gloo implements only broadcast, all_reduce and barrier on CUDA
    tensors).  The whole-batch host decisions of the fused dispatchers and
    the split runners reduce through `all_ranks` and `sum_ranks`, so every
    rank takes the arm the reference's global predicate takes.

Reads of a global result (the tests, the tools, the bench's sanity check)
go through `gather_groups`/`gather_state`, the counterpart of `np.asarray`
on a sharded `jax.Array`.  A spec here is the reference's PartitionSpec as
a plain tuple: the mesh axis name where an array axis is split, None where
it is whole, () for a replica.

`launch(n, fn, *args, devices=)` runs `fn(mesh, *args)` on n spawned
ranks and returns rank 0's result; a rank's failure fails the launcher.
The ranks meet through a `file://` store in a temporary directory: no
network and no ports.  NCCL joins ranks that each own a CUDA device, gloo
CPU ranks and ranks that share a card.  The default is one rank per
visible CUDA device; without a card and without `devices` this raises and
never falls back to CPU ranks.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from . import kernels, planes
from .kernels import ROLE_LEADER
from .sim import GroupShard, ShardConfig, SimConfig, SimState, global_groups

I32 = torch.int32
_INT32_MAX = 2**31 - 1
_INT32_MIN = -(2**31)

Spec = Tuple[Optional[str], ...]
DevicesLike = Optional[Union[str, torch.device, Sequence[Union[str, torch.device]]]]


class Mesh:
    """A 1-D mesh of ranks over the group axis, as seen from one rank: the
    process group's `size` ranks, this `rank`, its `device` and the
    `backend` joining them.  `block(G)` is this rank's [lo, hi) of a
    G-group batch."""

    def __init__(self, axis: str, rank: int, size: int, device: torch.device,
                 backend: str):
        self.axis = axis
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend

    def tile(self, n: int, what: str = "groups") -> int:
        """n / size; raises ValueError unless n tiles the mesh (the
        reference's placement requires equal blocks)."""
        if n % self.size:
            raise ValueError(
                f"{n} {what} do not tile the {self.size}-rank mesh: the "
                f"group axis splits into equal blocks, so it must divide by "
                f"{self.size}"
            )
        return n // self.size

    def block(self, n_groups: int) -> Tuple[int, int]:
        per = self.tile(n_groups)
        return self.rank * per, (self.rank + 1) * per

    def __repr__(self) -> str:
        return (f"Mesh(axis={self.axis!r}, rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")


def _mesh_devices(n_devices: Optional[int], devices: DevicesLike) -> List[torch.device]:
    """The ranks' devices: `devices` (one device or one per rank, the first
    n_devices of them), else one rank per visible CUDA device.  Raises
    RuntimeError for a CUDA request on a host without a card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sharding.make_mesh places one rank per CUDA device by "
                "default and none is available; pass devices=['cpu'] * n "
                "for CPU ranks"
            )
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"a {n}-rank mesh needs {n} CUDA devices, {count} visible")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * (1 if n_devices is None else n_devices)
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"a {n_devices}-rank mesh needs {n_devices} devices, "
                             f"got {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    out = []
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d} requested and no CUDA device "
                                   "is available")
            d = torch.device("cuda", 0 if d.index is None else d.index)
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}")
        out.append(d)
    return out


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank owns a CUDA device of its own, else gloo (CPU
    ranks, or ranks that share a card: NCCL refuses two ranks on one
    device)."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None, axis: str = "groups",
              devices: DevicesLike = None) -> Mesh:
    """The 1-D mesh over the group axis, from inside a rank of the process
    group that `launch` started (or any initialised one of the same size).
    `devices` pins the ranks' devices, and with them the backend, as the
    reference's `devices` pins its backend: one device or one per rank,
    e.g. ["cpu", "cpu"] for two CPU ranks.  Its default is one rank per
    visible CUDA device; with no card and no `devices` it raises."""
    devs = _mesh_devices(n_devices, devices)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh runs inside a rank of a process group: start the "
            "ranks with sharding.launch(n, fn, ...), which calls fn(mesh, ...)"
        )
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != len(devs):
        raise ValueError(f"the process group has {size} ranks, the mesh {len(devs)} devices")
    return Mesh(axis, rank, size, devs[rank], dist.get_backend())


# --- the launcher -------------------------------------------------------------


def _rank_main(rank: int, devs: List[str], backend: str, store_dir: str,
               fn: Callable, args: tuple) -> None:
    """One spawned rank: join the process group through the file store, run
    fn(mesh, *args), and (rank 0) save its result.  Any failure writes the
    traceback beside the store and exits 1 at once, without waiting for
    peers that may be blocked in a collective."""
    try:
        dev = torch.device(devs[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(store_dir, "store"),
            world_size=len(devs), rank=rank,
        )
        mesh = make_mesh(len(devs), devices=devs)
        out = fn(mesh, *args)
        if rank == 0:
            path = os.path.join(store_dir, "result.pt")
            torch.save(out, path + ".tmp")
            os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(store_dir, f"error.{rank}"), "w", encoding="utf-8") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def launch(n_devices: Optional[int], fn: Callable, *args, devices: DevicesLike = None,
           timeout: Optional[float] = None):
    """Run fn(mesh, *args) on n_devices spawned ranks (default: one per
    visible CUDA device) and return rank 0's result.  `fn` and `args` must
    pickle (fn a module-level function: the ranks import its module, so
    it must not import what the ranks should not load).  If any rank fails
    or `timeout` seconds pass, every rank is stopped and this raises
    RuntimeError with the first failing rank's traceback.  Build any
    kernel library the ranks need before calling, so that they load it
    instead of building it N times."""
    import multiprocessing as mp

    devs = _mesh_devices(n_devices, devices)
    backend = backend_for(devs)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="raft-mesh-") as store_dir:
        procs = [
            ctx.Process(target=_rank_main, name=f"mesh-rank-{r}",
                        args=(r, [str(d) for d in devs], backend, store_dir, fn, args))
            for r in range(len(devs))
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        failed = None
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    failed = -1
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed is not None:
            if failed < 0:
                raise RuntimeError(f"mesh ranks did not finish within {timeout} s")
            msgs = []
            for r in range(len(devs)):
                path = os.path.join(store_dir, f"error.{r}")
                if os.path.exists(path):
                    with open(path, encoding="utf-8") as f:
                        msgs.append(f"rank {r}:\n{f.read()}")
            detail = "\n".join(msgs) or "(no traceback: the rank was killed)"
            raise RuntimeError(
                f"mesh rank {failed} failed with exit code {procs[failed].exitcode}\n{detail}"
            )
        return torch.load(os.path.join(store_dir, "result.pt"), weights_only=False)


# --- cross-rank reductions ----------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def reduce_i32(mesh: Mesh, x, op: str = "sum") -> torch.Tensor:
    """All-reduce `x` (a tensor or int, taken as int32) over the mesh with
    `op` ("sum", "min" or "max"); a fresh int32 tensor on the rank's
    device.  int32 sums wrap as the reference's int32 planes do."""
    t = torch.as_tensor(x).to(device=mesh.device, dtype=I32).clone()
    dist.all_reduce(t, op=_OPS[op])
    return t


def all_ranks(cfg: SimConfig, pred) -> bool:
    """bool(pred) of the whole batch: off a mesh bool(pred); on a rank,
    pred (this rank's block) reduced as an int32 MIN over every rank, so
    every rank takes the same arm."""
    if cfg.shard is None:
        return bool(pred)
    return bool(reduce_i32(cfg.shard.mesh, pred, "min").item())


def sum_ranks(cfg: SimConfig, n) -> int:
    """int(n) summed over every rank's block (int(n) off a mesh)."""
    if cfg.shard is None:
        return int(n)
    return int(reduce_i32(cfg.shard.mesh, n, "sum").item())


def gather_groups(mesh: Mesh, t: torch.Tensor, n_groups: int) -> torch.Tensor:
    """The whole batch's [..., n_groups] plane from every rank's [..., G/N]
    block (an int32 or bool tensor): an all_reduce SUM of a zeroed global
    buffer in which each rank fills its block.  Every rank gets it."""
    lo, hi = mesh.block(n_groups)
    buf = torch.zeros(t.shape[:-1] + (n_groups,), dtype=I32, device=mesh.device)
    buf[..., lo:hi] = t.to(device=mesh.device, dtype=I32)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf != 0 if t.dtype == torch.bool else buf.to(t.dtype)


def gather_state(mesh: Mesh, st: SimState, n_groups: int) -> SimState:
    """The whole batch's SimState from every rank's block."""
    return SimState(*(None if v is None else gather_groups(mesh, v, n_groups)
                      for v in st))


def _gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """[size, *rows.shape]: every rank's fixed-size `rows` (int32), an
    all_reduce SUM of a zeroed [size, ...] buffer with this rank's row
    filled."""
    buf = torch.zeros((mesh.size,) + tuple(rows.shape), dtype=I32, device=mesh.device)
    buf[mesh.rank] = rows.to(device=mesh.device, dtype=I32)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def _topk_merge(keys: torch.Tensor, ids: torch.Tensor, k: int, descending: bool):
    """The first k of (key, id) candidates ordered by key (descending or
    ascending) with ties toward the lower id, along the last axis: a stable
    sort by id, then a stable sort by key."""
    by_id = torch.sort(ids, dim=-1, stable=True)
    keys = torch.gather(keys, -1, by_id.indices)
    order = torch.sort(keys, dim=-1, descending=descending, stable=True).indices[..., :k]
    return torch.gather(keys, -1, order), torch.gather(by_id.values, -1, order)


def health_summary(cfg: SimConfig, planes_: torch.Tensor):
    """kernels.health_summary of the whole batch at `cfg`'s thresholds and
    k = min(health_topk, global G), from this rank's [H, G/N] block: the
    counts and the lag histogram summed over ranks, the worst offenders a
    stable global top-k of every rank's local top-k over global ids, ties
    toward the lower id, as the reference's top_k breaks them.  Off a mesh
    it is kernels.health_summary itself."""
    k = min(cfg.health_topk, global_groups(cfg))
    args = (cfg.leaderless_stall_ticks, cfg.commit_stall_ticks, cfg.churn_bumps)
    if cfg.shard is None:
        return kernels.health_summary(planes_, *args, k)
    mesh, lo = cfg.shard.mesh, cfg.shard.lo
    kl = min(k, cfg.n_groups)
    counts, hist, ids, scores = kernels.health_summary(planes_, *args, kl)
    pad = k - kl
    ids = torch.cat([ids + lo, torch.full((pad,), _INT32_MAX, dtype=I32, device=ids.device)])
    scores = torch.cat([scores, torch.full((pad,), _INT32_MIN, dtype=I32, device=ids.device)])
    summed = reduce_i32(mesh, torch.cat([counts, hist]), "sum")
    cand = _gather_rows(mesh, torch.stack([ids, scores]))  # [N, 2, k]
    top_scores, top_ids = _topk_merge(cand[:, 1].reshape(-1), cand[:, 0].reshape(-1),
                                      k, descending=True)
    n = counts.numel()
    return summed[:n], summed[n:], top_ids, top_scores


def blackbox_capture(cfg: SimConfig, trip_round: torch.Tensor, k: int):
    """kernels.blackbox_capture of the whole batch from this rank's
    [N_SAFETY, G/N] first-trip block: the counts summed over ranks, the
    first k offenders per slot in (trip round, global id) order merged from
    every rank's own first k.  Off a mesh it is kernels.blackbox_capture."""
    if cfg.shard is None:
        return kernels.blackbox_capture(trip_round, k)
    mesh, lo = cfg.shard.mesh, cfg.shard.lo
    kl = min(k, cfg.n_groups)
    counts, ids, rounds = kernels.blackbox_capture(trip_round, kl)
    got = ids >= 0
    S = trip_round.shape[0]
    ids = torch.where(got, ids + lo, _INT32_MAX)
    rounds = torch.where(got, rounds, kernels.INF)
    pad = k - kl
    if pad:
        ids = torch.cat([ids, torch.full((S, pad), _INT32_MAX, dtype=I32, device=ids.device)], 1)
        rounds = torch.cat([rounds, torch.full((S, pad), kernels.INF, dtype=I32,
                                               device=ids.device)], 1)
    total = reduce_i32(mesh, counts, "sum")
    cand = _gather_rows(mesh, torch.stack([ids, rounds]))  # [N, 2, S, k]
    c_ids = cand[:, 0].permute(1, 0, 2).reshape(S, -1)
    c_rounds = cand[:, 1].permute(1, 0, 2).reshape(S, -1)
    top_rounds, top_ids = _topk_merge(c_rounds, c_ids, k, descending=False)
    hit = top_rounds < kernels.INF
    return total, torch.where(hit, top_ids, -1), torch.where(hit, top_rounds, -1)


def reduce_stats(cfg: SimConfig, stats: torch.Tensor, max_slots: Sequence[int] = ()):
    """A runner's int32 accumulator vector of the whole batch: every slot
    summed over ranks, except `max_slots` (running maxima), which take the
    MAX.  Off a mesh `stats` itself."""
    if cfg.shard is None:
        return stats
    mesh = cfg.shard.mesh
    out = reduce_i32(mesh, stats, "sum")
    if max_slots:
        mx = reduce_i32(mesh, stats, "max")
        idx = torch.tensor(list(max_slots), device=out.device)
        out[idx] = mx[idx]
    return out


# --- placement specs (the reference's PartitionSpecs as tuples) --------------


def _row_sharding(mesh: Mesh, axis: str, row) -> Spec:
    """The registry row's spec: "minor-G" splits the trailing group axis
    with every leading axis whole ("[P, G]" -> (None, axis), "[P, P, G]"
    -> (None, None, axis), "[G]" -> (axis,)); "replicate" is () (scalars,
    fixed-size accumulators)."""
    if row.sharding == "replicate":
        return ()
    assert row.sharding == "minor-G", row
    return (None,) * planes.leading_axes(row) + (axis,)


def state_sharding(mesh: Mesh, axis: str = "groups", damped: bool = False,
                   transfer: bool = False) -> SimState:
    """The spec of every SimState field, from the plane registry: the group
    axis is split, the peer axes stay whole.  A flag-gated row gets its
    spec only when its flag is on (`damped` for recent_active, `transfer`
    for transferee), else None, as the absent plane."""
    enabled = {"check_quorum": damped, "pre_vote": damped, "transfer": transfer}
    specs = {}
    for row in planes.rows(owner="SimState"):
        if row.flag and not any(enabled.get(f, False) for f in row.flag):
            specs[row.name] = None
        else:
            specs[row.name] = _row_sharding(mesh, axis, row)
    return SimState(**specs)


def _place(mesh: Mesh, x, spec: Optional[Spec], axis: str):
    """This rank's part of the global array `x` under `spec`: the mesh
    axis' dimension cut to the rank's equal block (a fresh contiguous
    tensor on the rank's device); a replica (spec ()) or a non-tensor is
    `x` itself."""
    if spec is None or x is None or not isinstance(x, torch.Tensor) or axis not in spec:
        return x
    dim = spec.index(axis)
    n = x.shape[dim]
    per = mesh.tile(n, f"entries on axis {dim}")
    return x.narrow(dim, mesh.rank * per, per).to(mesh.device).contiguous().clone()


def _place_tuple(mesh: Mesh, tup, specs, axis: str):
    return type(tup)(*(_place(mesh, v, s, axis) for v, s in zip(tup, specs)))


def local_config(cfg: SimConfig, mesh: Mesh) -> SimConfig:
    """The config of this rank's planes: n_groups its block's width, shard
    its GroupShard (global ids [lo, hi) of the global cfg.n_groups)."""
    G = global_groups(cfg)
    lo, hi = mesh.block(G)
    plain = SimConfig(*cfg)._replace(n_groups=hi - lo)
    return ShardConfig(plain, GroupShard(lo, hi, G, mesh))


def shard_state(state: SimState, mesh: Mesh, axis: str = "groups") -> SimState:
    """This rank's block of a whole-batch SimState."""
    specs = state_sharding(mesh, axis, damped=state.recent_active is not None,
                           transfer=state.transferee is not None)
    return _place_tuple(mesh, state, specs, axis)


def sharded_init_state(cfg: SimConfig, mesh: Mesh, voter_mask=None, outgoing_mask=None,
                       learner_mask=None, axis: str = "groups") -> SimState:
    """This rank's block of init_state(cfg) built in place on its device:
    no global [P, P, G] plane is ever built.  The timeouts are drawn from
    the block's GLOBAL ids, so every group gets the stream it has in the
    unsharded batch.  The optional config masks are whole-batch [P, G]."""
    lcfg = local_config(cfg, mesh)
    lo, hi = lcfg.shard.lo, lcfg.shard.hi
    spec = (None, axis)
    masks = [None if m is None else _place(mesh, torch.as_tensor(m), spec, axis)
             for m in (voter_mask, outgoing_mask, learner_mask)]
    from . import sim

    return sim.init_state(
        lcfg, *masks, device=mesh.device,
        group_ids=torch.arange(lo, hi, dtype=torch.int64, device=mesh.device),
    )


def health_sharding(mesh: Mesh, axis: str = "groups"):
    """HealthState specs: the [H, G] planes split on the group axis, the
    churn-window cursor whole."""
    from .sim import HealthState

    return HealthState(planes=(None, axis), window_pos=())


def shard_health(health, mesh: Mesh, axis: str = "groups"):
    """This rank's block of a whole-batch HealthState."""
    return _place_tuple(mesh, health, health_sharding(mesh, axis), axis)


def blackbox_sharding(mesh: Mesh, axis: str = "groups"):
    """BlackboxState specs from the registry: the [W, G] ring rows and the
    [N_SAFETY, G] first-trip plane split on their last axis, the round
    counter whole."""
    from .sim import BlackboxState

    return BlackboxState(**{
        row.name: _row_sharding(mesh, axis, row)
        for row in planes.rows(owner="BlackboxState")
    })


def shard_blackbox(blackbox, mesh: Mesh, axis: str = "groups"):
    """This rank's block of a whole-batch BlackboxState."""
    return _place_tuple(mesh, blackbox, blackbox_sharding(mesh, axis), axis)


def chaos_sharding(mesh: Mesh, axis: str = "groups"):
    """Specs of a compiled chaos schedule (chaos.CompiledChaos): every
    packed per-phase plane is group-minor ([NPH, W, G]: the word axis
    packs the P*P links, not groups), the per-phase append [NPH, G], the
    round-indexed phase_of_round whole."""
    from .chaos import CompiledChaos

    xg, xxg = (None, axis), (None, None, axis)
    return CompiledChaos(phase_of_round=(), link_packed=xxg, loss_packed=xxg,
                         crashed_packed=xxg, append=xg, n_peers=None)


def _place_schedule(mesh: Mesh, compiled, specs, axis: str):
    return compiled._replace(**{
        name: _place(mesh, getattr(compiled, name), getattr(specs, name), axis)
        for name in compiled._fields if name != "n_peers"
    })


def shard_chaos(compiled, mesh: Mesh, axis: str = "groups"):
    """This rank's block of a whole-batch compiled chaos schedule."""
    return _place_schedule(mesh, compiled, chaos_sharding(mesh, axis), axis)


def reconfig_sharding(mesh: Mesh, axis: str = "groups"):
    """(schedule specs, carry specs) of a reconfig run: the compiled
    schedule (reconfig.CompiledReconfig) and the op-protocol carry
    (reconfig.ReconfigState) split on the group axis like every [.., G]
    plane; phase_of_round whole."""
    from .reconfig import CompiledReconfig, ReconfigState

    g, xg, kpg = (axis,), (None, axis), (None, None, axis)
    sched = CompiledReconfig(
        phase_of_round=(), append=xg, op_start=xg, n_ops=g,
        tgt_voter=kpg, tgt_outgoing=kpg, tgt_learner=kpg,
        added=kpg, removed=kpg, n_peers=None,
    )
    rstate = ReconfigState(stage=g, op_ptr=g, prop_owner=g, prop_index=g,
                           prop_term=g, prev_voter=xg, prev_outgoing=xg)
    return sched, rstate


def shard_reconfig(compiled, rstate, mesh: Mesh, axis: str = "groups"):
    """This rank's blocks of a whole-batch compiled reconfig schedule and
    op-protocol carry (`rstate` may be None: schedule only)."""
    sched_sh, rstate_sh = reconfig_sharding(mesh, axis)
    placed = _place_schedule(mesh, compiled, sched_sh, axis)
    return placed, (None if rstate is None else _place_tuple(mesh, rstate, rstate_sh, axis))


def client_sharding(mesh: Mesh, axis: str = "groups"):
    """(schedule specs, carry specs, accumulator spec) of a client-workload
    run: the compiled schedule (workload.CompiledClient), its packed
    read-fire words included (their word axis is the group axis / 32), and
    the read carry (workload.ReadCarry) split on the group axis;
    phase_of_round and the accumulators whole."""
    from .workload import CompiledClient, ReadCarry

    g, xg = (axis,), (None, axis)
    sched = CompiledClient(phase_of_round=(), read_fire_packed=xg, read_mode=xg,
                           append=xg, n_peers=None)
    return sched, ReadCarry(pending_mode=g, pending_since=g), ()


def fire_words_tile(mesh: Mesh, n_words: int, n_groups: int) -> bool:
    """Whether the packed read-fire words split with the groups: the word
    count tiles the mesh and every rank's block starts on a word boundary
    (lo a multiple of 32), so a rank's words are exactly its groups' bits.
    Otherwise they stay whole on every rank, which unpacks its own block
    (workload.unpack_fires): a memory cost on read-only schedule data,
    never a correctness one."""
    if mesh.size == 1:
        return True
    return n_words % mesh.size == 0 and (n_groups // mesh.size) % 32 == 0


def shard_client(compiled, rcar, mesh: Mesh, axis: str = "groups"):
    """This rank's blocks of a whole-batch compiled client schedule and read
    carry (`rcar` may be None: schedule only), the read-fire words split
    or kept whole by fire_words_tile."""
    sched_sh, rcar_sh, _ = client_sharding(mesh, axis)
    G = compiled.read_mode.shape[-1]
    if not fire_words_tile(mesh, compiled.read_fire_packed.shape[1], G):
        sched_sh = sched_sh._replace(read_fire_packed=())
    placed = _place_schedule(mesh, compiled, sched_sh, axis)
    return placed, (None if rcar is None else _place_tuple(mesh, rcar, rcar_sh, axis))


# --- the step, the read barrier and the status reduction ---------------------


def _local_planes(lcfg: SimConfig, *xs):
    """Whole-batch per-round planes cut to the rank's block, contiguous (the
    fused kernels take raw pointers); planes already of the block's width
    pass through."""
    sh = lcfg.shard
    return tuple(
        x if x is None or x.shape[-1] == lcfg.n_groups
        else x[..., sh.lo:sh.hi].to(sh.mesh.device).contiguous()
        for x in xs
    )


def sharded_step(cfg: SimConfig, mesh: Mesh, axis: str = "groups"):
    """sim.step on this rank's block: fn(state, crashed, append_n) -> state,
    `state` the rank's block, crashed [P, G] and append_n [G] whole-batch
    (or already the block).  The node keys stay global.  (The reference's
    `donate` has no counterpart: steps here never update in place.)"""
    from . import sim

    lcfg = local_config(cfg, mesh)

    def fn(st: SimState, crashed, append_n) -> SimState:
        crashed, append_n = _local_planes(lcfg, crashed, append_n)
        return sim.step(lcfg, st, crashed, append_n)

    return fn


def sharded_read_index(cfg: SimConfig, mesh: Mesh, axis: str = "groups"):
    """sim.read_index on this rank's block: fn(state, crashed) -> int32[G/N],
    the rank's groups' read indices, with no cross-rank traffic."""
    from . import sim

    lcfg = local_config(cfg, mesh)

    def fn(st: SimState, crashed) -> torch.Tensor:
        (crashed,) = _local_planes(lcfg, crashed)
        return sim.read_index(lcfg, st, crashed)

    return fn


def global_status(cfg: SimConfig, mesh: Mesh, axis: str = "groups"):
    """The MultiRaftStatus reduction: fn(state) -> dict of n_leaders (groups
    led), min_commit (the least group commit), max_term, and total_commit
    (the sum of each group's leader commit, an EXACT Python int), reduced
    over every rank from its block; every value a Python int.

    total_commit: each group's leader commit splits into its four 8-bit
    limbs, each limb summed as int32 over the whole batch (bounded by
    n_groups * 255 < 2**31, checked here: about 8.4M groups), and the host
    recombines them, sum(limb_i << 8*i), in unbounded ints."""
    G = global_groups(cfg)
    if G * 255 >= 2**31:
        raise ValueError(
            f"global_status limb sums can wrap int32 at n_groups="
            f"{G} (needs n_groups * 255 < 2**31, ~8.4M groups);"
            " widen the limb split to 4-bit nibbles for larger fleets"
        )

    def status(st: SimState) -> dict:
        is_leader = st.state == ROLE_LEADER
        has_leader = is_leader.any(0)
        lead_commit = torch.where(is_leader, st.commit, 0).amax(0)
        group_commit = st.commit.amax(0)
        limbs = torch.stack([((lead_commit >> (8 * i)) & 0xFF).sum(dtype=I32)
                             for i in range(4)])
        sums = reduce_i32(mesh, torch.cat([has_leader.sum(dtype=I32)[None], limbs]), "sum")
        lo = reduce_i32(mesh, group_commit.amin(), "min")
        hi = reduce_i32(mesh, st.term.amax(), "max")
        vals = torch.cat([sums, lo[None], hi[None]]).tolist()
        return {
            "n_leaders": vals[0],
            "min_commit": vals[5],
            "max_term": vals[6],
            "total_commit": sum(v << (8 * i) for i, v in enumerate(vals[1:5])),
        }

    return status


def run_sharded(cfg: SimConfig, mesh: Mesh, rounds: int, axis: str = "groups"):
    """Initialise on the mesh and advance `rounds` rounds of one append a
    group through ClusterSim(mesh=).run_compiled; returns (this rank's
    final state block, the global status dict)."""
    from . import sim

    cs = sim.ClusterSim(cfg, mesh=mesh, mesh_axis=axis)
    append = torch.ones((cfg.n_groups,), dtype=I32, device=mesh.device)
    cs.run_compiled(rounds, append_n=append)
    return cs.state, global_status(cs.cfg, mesh, axis)(cs.state)
