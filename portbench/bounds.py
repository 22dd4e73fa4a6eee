"""The table of peaks and the frozen floors of the fused kernels' work.

A kernel's bound is the least time an H100 could take for the call: the
larger of its bytes (each operand read once, each output written once)
over the HBM bandwidth and its integer operations over the INT32 issue
rate.  Both are functions of G, P, k and the flags alone, reckoned here
once, so the bound stays the same whatever implements the kernel.

Peaks: NVIDIA H100 SXM5 80 GB (data sheet; 700 W): HBM3 at 3.35 TB/s;
132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 T INT32 operations/s.

Operation floors, per group and round of a settled block (one acting
leader, every peer alive), counting one operation per value computed:
  steady   5P: each peer's election clock (P), the leader's heartbeat
           clock (1), the leader's append and each follower's adoption
           of the tail (P), the leader's matched slots for its P - 1
           followers (P - 1), the majority index, a selection of at least
           P - 1 comparisons, the term-start gate and the leader's commit
           (2), each follower's commit (P - 1).  At P = 3, 15, under the
           59 of the steady kernel's source count (15P + 14).
  damped   6P - 1: the steady floor and each follower's bit of the
           leader's recent_active row (P - 1); the check-quorum boundary
           comes once in election_tick rounds and counts nothing.
Bytes, no loss and no health planes (int32 planes 4 bytes, masks 1):
  steady   in: 8 int32 [P, G] planes (state, term, both clocks, last index
           and term, the leader's matched row, commit), 3 masks, 2 int32
           [G] rows; out: 6 int32 [P, G] planes.  59 P G + 8 G.
  damped   in: 8 int32 [P, G] planes (state, leader id, both clocks, last
           index and term, commit, the leader's matched row), 4 masks (the
           leader's recent_active row, voter, member, crashed), agree
           [P, P, G], 3 int32 [G] rows; out: 8 int32 [P, G] planes, the
           recent_active row, agree.  69 P G + 8 P^2 G + 12 G.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12


def steady_work(G: int, P: int, k: int) -> Tuple[int, int]:
    """(bytes, operations) of k steady rounds of G groups of P peers."""
    return 59 * P * G + 8 * G, 5 * P * k * G


def damped_work(G: int, P: int, k: int) -> Tuple[int, int]:
    """(bytes, operations) of k damped rounds (check quorum, pre-vote)."""
    return 69 * P * G + 8 * P * P * G + 12 * G, (6 * P - 1) * k * G


WORK = {"steady": steady_work, "damped": damped_work}


def bound(kernel: str, G: int, P: int, k: int) -> Tuple[float, str]:
    """(seconds, 'bytes' or 'operations'): the least time of one call."""
    nbytes, ops = WORK[kernel](G, P, k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_share(ctx, kernel: str):
    """The bound of one call of `kernel` over its device time a call, in %,
    from the traced fused blocks; None where none ran."""
    if ctx.trace is None or not ctx.fused_kernel.startswith(kernel):
        return None
    calls = [o.dur for b, ops in zip(ctx.traced, ctx.trace.blocks) if b.fused
             for o in ops if ctx.fused_kernel in o.name]
    if not calls:
        return None
    bound_s, _ = bound(kernel, ctx.G, ctx.P, ctx.k)
    return 100.0 * bound_s / (sum(calls) / len(calls) / 1e6)
