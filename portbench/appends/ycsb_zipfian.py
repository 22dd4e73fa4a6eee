"""YCSB's scrambled Zipfian request distribution, as appends.

Each row is one round of a fleet's writes: `updates_per_group_round`
updates a group on average (so a fleet of G groups takes that times G),
each to a key drawn as YCSB's `ScrambledZipfianGenerator` draws it (a
rank from Gray et al.'s Zipfian generator over 10^10 items with YCSB's
constant theta = 0.99, hashed with YCSB's FNV-1a-64 onto the key space).
The key space is split into equal contiguous ranges, one a group, as a
multi-Raft store splits its keys into regions.  A group's leader proposes
one entry per update that lands on it, so most groups propose nothing in
a round and a few hot ones propose hundreds.

Parameters: `updates_per_group_round`, `keys_per_group`, `rows` (distinct
rounds drawn; the blocks cycle through them), `theta`, `items`.
"""

from __future__ import annotations

import numpy as np
import torch

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


def zeta(n: int, theta: float, exact: int = 1_000_000) -> float:
    """sum_{i=1..n} i^-theta: the first `exact` terms summed, the rest by
    Euler-Maclaurin (its error is far below a double's rounding here)."""
    m = min(n, exact)
    head = float(np.sum(np.arange(1, m + 1, dtype=np.float64) ** -theta))
    if n == m:
        return head
    f = lambda x: float(x) ** -theta  # noqa: E731
    df = lambda x: -theta * float(x) ** (-theta - 1)  # noqa: E731
    tail = ((float(n) ** (1 - theta) - float(m) ** (1 - theta)) / (1 - theta)
            + (f(n) - f(m)) / 2 + (df(n) - df(m)) / 12)
    return head + tail


def zipfian_ranks(u: np.ndarray, items: int, theta: float) -> np.ndarray:
    """YCSB's ZipfianGenerator.nextLong for uniform draws `u` in [0, 1):
    rank 0 is the most popular item."""
    zetan = zeta(items, theta)
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - (2.0 / items) ** (1 - theta)) / (1 - zeta(2, theta) / zetan)
    uz = u * zetan
    tail = (items * (eta * u - eta + 1) ** alpha).astype(np.int64)
    return np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1, tail))


def fnvhash64(v: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64: FNV-1a over the value's 8 bytes, low byte
    first, as a non-negative int64."""
    v = v.astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            v >>= np.uint64(8)
            h *= np.uint64(FNV_PRIME_64)
    return np.abs(h.view(np.int64))


def rows(params: dict, n_groups: int, seed: int, device) -> torch.Tensor:
    """int32[rows, G]: entries each group's leader proposes in a round."""
    n_rows = params["rows"]
    w = max(1, round(params["updates_per_group_round"] * n_groups))
    keys = n_groups * params["keys_per_group"]
    u = np.random.default_rng([seed, 3]).random(n_rows * w)
    ranks = zipfian_ranks(u, params["items"], params["theta"])
    group = (fnvhash64(ranks) % keys) // params["keys_per_group"]
    flat = torch.from_numpy(group + np.repeat(np.arange(n_rows) * n_groups, w)).to(device)
    out = torch.zeros(n_rows * n_groups, dtype=torch.int32, device=device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.view(n_rows, n_groups)
