"""The benchmark's metric arithmetic: tails and recovery times.

Every tail is a nearest-rank percentile over all samples of the window.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch

ROLE_LEADER = 2


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank q-th percentile (the smallest value with at least q %
    of the samples at or below it)."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def weighted_percentile(values: Sequence[float], weights: Sequence[int], q: float) -> float:
    """Nearest-rank percentile of `values[i]` repeated `weights[i]` times."""
    pairs = sorted((v, w) for v, w in zip(values, weights) if w > 0)
    total = sum(w for _, w in pairs)
    if total == 0:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q / 100 * total))
    seen = 0
    for v, w in pairs:
        seen += w
        if seen >= rank:
            return v
    return pairs[-1][0]


def recovered(st, crashed: torch.Tensor) -> torch.Tensor:
    """bool[G]: the group has a live leader at its highest live term that
    has committed an entry of its own term (its commit reached the noop
    it appended on election)."""
    alive = ~crashed
    lead = (st.state == ROLE_LEADER) & alive
    top = torch.where(alive, st.term, -1).amax(0)
    acting = lead & (st.term == top[None, :])
    own = acting & (st.term_start_index > 0) & (st.commit >= st.term_start_index)
    return own.any(0)


class Incident:
    """One fault's groups that lost their leader, and the block after which
    each first recovered (-1: not yet)."""

    def __init__(self, t_issue: float, first_block: int, lost: torch.Tensor):
        self.t_issue = t_issue
        self.first_block = first_block
        self.lost = lost
        self.n_lost = int(lost.sum())
        self.rec = torch.full_like(lost, -1, dtype=torch.int32)
        self.open = self.n_lost > 0

    def update(self, block: int, st, crashed) -> None:
        """Mark the lost groups that `st`, the state after `block`, shows
        recovered; the incident closes when none is left."""
        newly = self.lost & (self.rec < 0) & recovered(st, crashed)
        self.rec = torch.where(newly, block, self.rec)
        self.open = bool((self.lost & (self.rec < 0)).any())

    def samples(self, block_end: List[float], window_end: float):
        """(seconds, group count) pairs: from the incident's first block's
        issue to the end of the block after which a group recovered; a
        group still down when the window closed counts at its close."""
        rec = self.rec[self.lost]
        pending = int((rec < 0).sum())
        done = rec[rec >= 0].to(torch.int64) - self.first_block
        out = []
        if done.numel():
            counts = torch.bincount(done).tolist()
            out = [(block_end[self.first_block + i] - self.t_issue, c)
                   for i, c in enumerate(counts) if c]
        if pending:
            out.append((window_end - self.t_issue, pending))
        return out


def rate_by_slice(blocks, t_start: float, t_end: float, slices: int) -> List[float]:
    """Rounds a second in each of `slices` equal parts of the window, each
    block counted in the part where it ended."""
    width = (t_end - t_start) / slices
    rounds = [0] * slices
    for b in blocks:
        rounds[min(slices - 1, int((b.t_end - t_start) / width))] += b.rounds
    return [r / width for r in rounds]


class BlockRecord(NamedTuple):
    index: int
    t_issue: float  # host clock at the call
    t_end: float  # host clock once its outputs are synchronised
    fused: bool  # the dispatcher ran the fused kernel
    rounds: int
    traced: bool  # inside the profiler's sub-window
