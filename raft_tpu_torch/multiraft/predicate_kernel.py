"""The dispatcher's steady invariant as one hand-written CUDA kernel.

Replaces no TPU kernel: the reference's `pallas_step.steady_mask` (:1355)
is elementwise JAX that XLA fuses.  On the card the port's composition of
it (`fused_step.steady_mask` and `kernels.cq_boundary_safe`) is about 87
PyTorch operations a call on a check-quorum config and 29 on a plain one,
each reading a few MB of a [P, G] plane and writing a temporary; the host
issues them one by one while the card waits, and the block's `bool()`
waits behind them.  This kernel computes the same bool per group, and the
whole batch's AND, in one pass (csrc/steady_predicate.cu over
csrc/steady_predicate.cuh): one thread a group, P a run-time argument,
each block's AND by `__syncthreads_and` and one `atomicAnd` a failing
block into an int32 flag.  A predicate is at most two device operations,
the flag's set and the kernel.

Bound on an H100: bytes.  The call reads four int32 [P, G] planes and
three one-byte ones, with check quorum the alive leader's recent_active
row (P bytes a group: a group with two alive leaders fails whatever its
rows hold, so no other row is read), and the optional transferee plane and
pending rows; `predicate_work` counts them.  At 1M groups x 3 peers that
is 57 MB plain and 60 MB with check quorum, 17.0 and 17.9 us at 3.35 TB/s;
its integer work (about 20 operations a peer) is a tenth of that.  The
loads are the cost: a thread issues a batch of peers' loads at once
(csrc's kPeerBatch), so a group of 3 peers takes one round trip to memory,
two with check quorum.  On an H100 80GB HBM3 at 700 W a call, the flag's
set included, took 25.6 us plain and 35.0 us with check quorum in a
benchmark block (PERF.md, section 6).

`fused_step.steady_mask` and `steady_predicate` take the kernel on CUDA
tensors without a link plane; the composition stays the plain version for
the CPU and the link and loss arms, and the tests hold the kernel's body
(built with g++ as csrc/steady_predicate_host.cpp) to it group by group.
`steady_invariant.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .platform import check_operands
from .sim import SimConfig, SimState

I32 = torch.int32
# csrc/steady_predicate.cuh's flag bits.
_BLACKBOX, _CHECK_QUORUM, _PRE_VOTE = 1, 2, 4
_INT32 = (-(2**31), 2**31 - 1)


def _flags(cfg: SimConfig) -> int:
    """The SimConfig fields the body reads, as its `flags` bits."""
    return ((_BLACKBOX if cfg.blackbox else 0)
            | (_CHECK_QUORUM if cfg.check_quorum else 0)
            | (_PRE_VOTE if cfg.pre_vote else 0))


def _rejects_all(cfg: SimConfig) -> bool:
    """True where the invariant fails for every group whatever the state: a
    black-box config, or a damped one with election_tick <= heartbeat_tick."""
    damped = cfg.check_quorum or cfg.pre_vote
    return cfg.blackbox or (damped and cfg.election_tick <= cfg.heartbeat_tick)


def missing_recent_active() -> ValueError:
    """The error of a check-quorum state without its recent_active plane,
    on the kernel's route and the composition's alike."""
    return ValueError(
        "steady_mask for a check_quorum config needs the recent_active plane "
        "but the state has None; rebuild it with init_state(cfg)"
    )


def _operands(cfg: SimConfig, st: SimState, crashed: torch.Tensor, horizon: int,
              reconfig_pending, read_pending) -> list:
    """The launcher's 11 operand tensors (None for a null pointer), checked
    for device, dtype, shape and contiguity."""
    if not _INT32[0] <= horizon <= _INT32[1]:
        raise ValueError(f"steady predicate: horizon {horizon} outside int32")
    P, G = st.term.shape
    dev = st.term.device
    ra = st.recent_active if cfg.check_quorum else None
    if cfg.check_quorum and ra is None and not _rejects_all(cfg):
        raise missing_recent_active()
    # The composition took the caller's masks in any layout: so does this.
    crashed, reconfig_pending, read_pending = (
        None if t is None else t.contiguous()
        for t in (crashed, reconfig_pending, read_pending))
    planes = dict(state=st.state, term=st.term, election_elapsed=st.election_elapsed,
                  randomized_timeout=st.randomized_timeout)
    masks = dict(voter=st.voter_mask, outgoing=st.outgoing_mask, crashed=crashed)
    opt = dict(transferee=st.transferee)
    rows = dict(reconfig_pending=reconfig_pending, read_pending=read_pending)
    given = lambda d: {k: v for k, v in d.items() if v is not None}  # noqa: E731
    check_operands("steady predicate", dev, (
        (planes, (P, G), I32), (masks, (P, G), torch.bool),
        (given(opt), (P, G), I32), (given(rows), (G,), torch.bool),
        (given(dict(recent_active=ra)), (P, P, G), torch.bool),
    ))
    return [*planes.values(), *masks.values(), ra, st.transferee,
            reconfig_pending, read_pending]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def steady_invariant(
    cfg: SimConfig, st: SimState, crashed: torch.Tensor, horizon: int = 1,
    reconfig_pending=None, read_pending=None, *, whole: bool = False,
) -> torch.Tensor:
    """fused_step.steady_mask without a link plane, on the card: the bool[G]
    mask, or with `whole` the whole batch's AND as a 0-dim bool tensor (the
    mask is then not written).  The state, `crashed` and the optional
    bool[G] `reconfig_pending` / `read_pending` lie on one CUDA device."""
    operands = _operands(cfg, st, crashed, horizon, reconfig_pending, read_pending)
    P, G = st.term.shape
    dev = st.term.device
    mask = None if whole else torch.empty((G,), dtype=torch.bool, device=dev)
    # One int32 word; its first byte is the bool (see steady_predicate.cu).
    flag = torch.empty((4,), dtype=torch.bool, device=dev) if whole else None
    lib = _build.load_predicate_cuda()
    with torch.cuda.device(dev):
        rc = lib.steady_predicate_launch(
            *map(_ptr, operands), _ptr(mask), _ptr(flag), G, P, horizon,
            cfg.election_tick, cfg.heartbeat_tick, _flags(cfg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"steady_predicate_launch failed: CUDA error {rc}")
    steady_invariant.launches += 1
    return flag[0] if whole else mask


steady_invariant.launches = 0


def host_invariant(
    cfg: SimConfig, st: SimState, crashed: torch.Tensor, horizon: int = 1,
    reconfig_pending=None, read_pending=None,
) -> Tuple[torch.Tensor, bool]:
    """The kernel's body built with g++ (csrc/steady_predicate_host.cpp) on
    CPU tensors, for the tests: (the bool[G] mask, the whole-batch flag as
    the grid reduces it)."""
    operands = _operands(cfg, st, crashed, horizon, reconfig_pending, read_pending)
    P, G = st.term.shape
    mask = torch.empty((G,), dtype=torch.bool)
    flag = torch.empty((4,), dtype=torch.bool)
    rc = _build.load_predicate_host().steady_predicate_host(
        *map(_ptr, operands), _ptr(mask), _ptr(flag), G, P, horizon,
        cfg.election_tick, cfg.heartbeat_tick, _flags(cfg),
    )
    if rc != 0:
        raise RuntimeError(f"steady_predicate_host refused its arguments ({rc})")
    return mask, bool(flag[0])


def predicate_work(P: int, G: int, check_quorum: bool) -> int:
    """Bytes the dispatcher's call (`whole`, no transferee plane, no
    pending rows) needs, each read or written once: four int32 and three
    one-byte [P, G] planes, with check quorum the leader's recent_active
    row (P bytes a group), and the 4-byte flag."""
    return (4 * 4 + 3) * P * G + (P * G if check_quorum else 0) + 4
