"""A store fails and comes back.

Replica p of group g lives on store (g + p) mod `stores`.  Every
`every_rounds` rounds a store drawn from the seed fails for `down_rounds`
rounds: every replica it holds is crashed (it keeps ticking and exchanges
no messages), then it restarts with its state.  Each failure starts an
incident.
"""

from __future__ import annotations

import numpy as np
import torch

# A restart keeps each replica's state, so a committed index never goes back.
resets = False


def store_masks(stores: int, n_peers: int, n_groups: int, device) -> torch.Tensor:
    """bool[stores, P, G]: mask s marks the replicas store s holds."""
    g = torch.arange(n_groups, device=device)[None, :]
    p = torch.arange(n_peers, device=device)[:, None]
    on = (g + p) % stores
    return torch.stack([on == s for s in range(stores)])


class Faults:
    def __init__(self, params: dict, n_groups: int, n_peers: int, k: int, seed: int,
                 device):
        if params["down_rounds"] % k:
            raise ValueError(f"down_rounds {params['down_rounds']} is not a multiple "
                             f"of k = {k}")
        self.period = params["every_rounds"]
        self.down = params["down_rounds"]
        self.n_stores = params["stores"]
        self.masks = store_masks(self.n_stores, n_peers, n_groups, device)
        self._rng = np.random.default_rng([seed, 1])
        self.stores: list = []

    def store(self, incident: int) -> int:
        """The store that fails in the `incident`-th period."""
        while len(self.stores) <= incident:
            self.stores.extend(int(s) for s in self._rng.integers(0, self.n_stores, 64))
        return self.stores[incident]

    def at(self, round_no: int):
        """(crashed bool[P, G] or None, reset bool[G] or None, incident) for
        the block that starts at `round_no`."""
        pos = round_no % self.period
        crashed = self.masks[self.store(round_no // self.period)] if pos < self.down else None
        return crashed, None, pos == 0
