"""The whole fleet restarts.

Every `every_rounds` rounds, before that round, every group restarts from
its initial state: every peer a follower at term 0 with an empty log, so
every group elects a leader again.  Each restart starts an incident.
"""

from __future__ import annotations

import torch

# A restart from the initial state takes commits back to 0.
resets = True


class Faults:
    def __init__(self, params: dict, n_groups: int, n_peers: int, k: int, seed: int,
                 device):
        self.period = params["every_rounds"]
        self.everyone = torch.ones((n_groups,), dtype=torch.bool, device=device)

    def at(self, round_no: int):
        if round_no % self.period:
            return None, None, False
        return None, self.everyone, True
