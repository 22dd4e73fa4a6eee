"""Elementwise protocol kernels on [P, G] tensors: the subset of
`raft_tpu/multiraft/kernels.py` that the plain step of the main path calls.

Counterparts (reference file `raft_tpu/multiraft/kernels.py`):
  INF, VOTE_*      :162-167
  _mix32           :331
  timeout_draw     :1258
  ROLE_*           :1280-1283
  tick_kernel      :1628

The reference computes the timeout PRNG in uint32.  PyTorch's uint32
tensors do not support `>>`, `+`, `%` or `<` on every backend, so here the
words live in int64 holding values in [0, 2**32), and every multiply and
add is followed by `& 0xFFFFFFFF`.  Multiplies by a 32-bit constant are
split into two 16-bit halves (`_mul32`) so no intermediate product leaves
the signed int64 range: the low 32 bits are exact without relying on
overflow wrapping.
"""

from __future__ import annotations

from typing import Tuple

import torch

INF = 2**31 - 1

# Vote results as int codes matching quorum.VoteResult.
VOTE_PENDING = 0
VOTE_LOST = 1
VOTE_WON = 2

# State role codes matching raft.StateRole.
ROLE_FOLLOWER = 0
ROLE_CANDIDATE = 1
ROLE_LEADER = 2
ROLE_PRE_CANDIDATE = 3

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c < 2**32,
    with every intermediate below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit murmur3 finalizer on int64 words holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def timeout_draw(
    node_key: torch.Tensor,  # int64[...] holding uint32 values
    epoch: torch.Tensor,  # int64[...] holding uint32 values
    lo: torch.Tensor,  # int32[...]
    hi: torch.Tensor,  # int32[...]
) -> torch.Tensor:
    """Randomized election timeout in [lo, hi) — the same 32-bit
    murmur3-finalizer mix as the reference's timeout_draw.  Returns int32."""
    x = (_mul32(node_key & _MASK32, 0x9E3779B1) + (epoch & _MASK32)) & _MASK32
    x = _mix32(x)
    span = (hi.to(torch.int64) - lo.to(torch.int64)) & _MASK32
    out = ((lo.to(torch.int64) & _MASK32) + x % span) & _MASK32
    # uint32 -> int32 reinterpretation, as the reference's astype does.
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32)


def tick_kernel(
    state: torch.Tensor,  # int32[...]
    election_elapsed: torch.Tensor,  # int32[...]
    heartbeat_elapsed: torch.Tensor,  # int32[...]
    randomized_timeout: torch.Tensor,  # int32[...]
    promotable: torch.Tensor,  # bool[...]
    election_timeout: int,
    heartbeat_timeout: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One logical-clock tick for every node (reference: raft.rs:1024-1079).

    Returns (election_elapsed', heartbeat_elapsed', want_campaign,
    want_heartbeat, want_check_quorum), as the reference's tick_kernel."""
    is_leader = state == ROLE_LEADER

    ee = election_elapsed + 1
    hb = torch.where(is_leader, heartbeat_elapsed + 1, heartbeat_elapsed)

    pass_election = ee >= randomized_timeout
    want_campaign = ~is_leader & pass_election & promotable
    ee = torch.where(want_campaign, 0, ee)

    want_check_quorum = is_leader & (ee >= election_timeout)
    ee = torch.where(want_check_quorum, 0, ee)

    want_heartbeat = is_leader & (hb >= heartbeat_timeout)
    hb = torch.where(want_heartbeat, 0, hb)

    return ee, hb, want_campaign, want_heartbeat, want_check_quorum
