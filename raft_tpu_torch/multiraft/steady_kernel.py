"""k fused steady protocol rounds: the hand-written CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces `raft_tpu/multiraft/pallas_step.py:_steady_kernel` (the
`with_health=False` variant, built by `steady_round` at :549).  Over
`rounds` rounds, with the crash mask and the append count held constant,
each group's timers tick by role (the leader heartbeats), the alive leader
appends `app` entries, alive members sync to it (ee -> 0, adopt its log
tail, their slots of the acting matched row follow), and the leader's
commit advances to the voters' majority index once that index reaches the
leader's term start.

Bound on an H100: the call is one pass over its operands.  With bool masks
as one-byte planes it reads 8 int32 and 3 one-byte [P, G] planes plus two
int32 [G] rows, and writes 6 int32 [P, G] planes: (8·4 + 3 + 6·4)·P·G +
8·G bytes, 30.3 MB at P=5, G=100k, or 9.0 µs at 3.35 TB/s.  The integer
work grows with `rounds` (208 operations per group and round at P=5,
`steady_work`): at k=32 that is 666 M operations, 9.9 µs at the card's
67 T/s non-tensor rate, so operations and bytes bound it about equally.
The design keeps both low: one thread per group holds its P-column of
every plane in registers for all k rounds (csrc/steady_body.cuh, P a
template parameter so the peer loops and the odd-even network unroll), so
each byte crosses the memory bus once per call, and the peer-major layout
makes neighbouring threads touch neighbouring words.  On the card it runs
several times over that bound, limited by integer issue: 100k groups give
only about 760 threads an SM, each running a long dependent chain.

On CPU tensors `steady_rounds` runs `steady_rounds_reference`, the same
arithmetic as plain tensor code; on CUDA tensors it launches the kernel or
raises.  `steady_rounds.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .kernels import ROLE_LEADER

I32 = torch.int32
MAX_PEERS = 7

Outputs = Tuple[torch.Tensor, ...]


def steady_rounds_reference(
    state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, *, rounds: int, election_tick: int, heartbeat_tick: int,
) -> Outputs:
    """Plain PyTorch version of the kernel: planes [P, G] (int32; masks
    bool or 0/1 ints), ts and app [G] int32.  Returns (ee, hb, li, lt,
    acting_row, commit) as fresh int32 [P, G] tensors."""
    P = state.shape[0]
    voter, member, crashed = voter != 0, member != 0, crashed != 0
    matched = acting_row
    alive = ~crashed
    role_leader = state == ROLE_LEADER
    is_leader = role_leader & alive
    has_leader = is_leader.any(0)  # [G]
    qpos = voter.sum(0, dtype=I32) // 2
    n_app = torch.where(has_leader, app, 0)
    for _ in range(rounds):
        ee = ee + 1
        ee = torch.where(role_leader & (ee >= election_tick), 0, ee)
        hb = torch.where(role_leader, hb + 1, hb)
        want_beat = role_leader & (hb >= heartbeat_tick)
        hb = torch.where(want_beat, 0, hb)

        li = li + torch.where(is_leader, n_app, 0)
        lt = torch.where(is_leader, term, lt)
        lead_last = torch.where(is_leader, li, 0).sum(0, dtype=I32)
        lead_lt = torch.where(is_leader, lt, 0).sum(0, dtype=I32)

        lead_beat = (want_beat & is_leader).any(0)
        sent = has_leader & (lead_beat | (n_app > 0))

        sync = sent & alive & member & ~is_leader
        ee = torch.where(sync, 0, ee)
        li = torch.where(sync, lead_last, li)
        lt = torch.where(sync, lead_lt, lt)
        matched = torch.where(sync | (is_leader & sent), li, matched)

        rows = [torch.where(voter[p], matched[p], 0) for p in range(P)]
        for pass_ in range(P):
            for i in range(pass_ % 2, P - 1, 2):
                hi = torch.maximum(rows[i], rows[i + 1])
                lo = torch.minimum(rows[i], rows[i + 1])
                rows[i], rows[i + 1] = hi, lo
        mci = torch.zeros_like(rows[0])
        for p in range(P):
            mci = torch.where(qpos == p, rows[p], mci)

        ok = has_leader & sent & (mci >= ts)
        lead_commit_old = torch.where(is_leader, commit, 0).sum(0, dtype=I32)
        lead_commit = torch.where(
            ok, torch.maximum(lead_commit_old, mci), lead_commit_old
        )
        commit = torch.where((is_leader | sync) & sent, lead_commit, commit)
    return ee, hb, li, lt, matched, commit


def steady_work(P: int, G: int, rounds: int) -> Tuple[int, int]:
    """(bytes, integer operations) one call needs: each operand read once
    and each output written once, with one-byte masks; and the elementwise
    operations of the reference's round (9P tick, 7P append, 2P+3 beat,
    10P sync, P masking plus 2 per comparator of the network, 2P for the
    quorum pick, 2P+5 commit, 3P broadcast) times rounds."""
    nbytes = (8 * 4 + 3 + 6 * 4) * P * G + 2 * 4 * G
    comparators = sum(len(range(s % 2, P - 1, 2)) for s in range(P))
    per_round = 36 * P + 8 + 2 * comparators
    return nbytes, per_round * rounds * G


def _launch(
    state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, rounds: int, election_tick: int, heartbeat_tick: int,
) -> Outputs:
    P, G = state.shape
    if not 1 <= P <= MAX_PEERS:
        raise ValueError(f"steady_rounds: P={P} outside 1..{MAX_PEERS}")
    dev = state.device
    planes = dict(state=state, term=term, ee=ee, hb=hb, li=li, lt=lt,
                  acting_row=acting_row, commit=commit)
    masks = dict(voter=voter, member=member, crashed=crashed)
    rows = dict(ts=ts, app=app)
    for group, shape, dtype in (
        (planes, (P, G), I32), (masks, (P, G), torch.bool), (rows, (G,), I32)
    ):
        for name, t in group.items():
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"steady_rounds: {name} must be {dtype} {list(shape)} on "
                    f"{dev}, got {t.dtype} {list(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"steady_rounds: {name} must be contiguous")
    outs = tuple(torch.empty((P, G), dtype=I32, device=dev) for _ in range(6))
    lib = _build.load_steady_cuda()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [t.data_ptr() for t in (*planes.values(), *masks.values(),
                                       *rows.values(), *outs)]
        rc = lib.steady_round_launch(
            *args, G, P, rounds, election_tick, heartbeat_tick, stream
        )
    if rc != 0:
        raise RuntimeError(f"steady_round_launch failed: CUDA error {rc}")
    steady_rounds.launches += 1
    return outs


def steady_rounds(
    state, term, ee, hb, li, lt, acting_row, commit, voter, member, crashed,
    ts, app, *, rounds: int, election_tick: int, heartbeat_tick: int,
) -> Outputs:
    """`rounds` fused steady rounds; returns (ee, hb, li, lt, acting_row,
    commit).  Planes [P, G] int32, masks [P, G] bool, ts and app [G] int32.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors run the
    plain version."""
    args = (state, term, ee, hb, li, lt, acting_row, commit, voter, member,
            crashed, ts, app)
    kw = dict(rounds=rounds, election_tick=election_tick,
              heartbeat_tick=heartbeat_tick)
    if state.is_cuda:
        return _launch(*args, **kw)
    if any(t.is_cuda for t in args):
        raise ValueError("steady_rounds: tensors on mixed devices")
    return steady_rounds_reference(*args, **kw)


steady_rounds.launches = 0
