"""The one traffic generator: turns a traffic file's parameters and a seed
into each block's inputs.

A traffic file names an append distribution, a fault kind or null, and,
optionally, a conf-change kind, each with its parameters.  Each is a
module of its own, found by name:

    appends/<dist>.py   rows(params, G, seed, device) -> int32[rows, G]:
                        the entries each group's leader proposes in a
                        round, one row a round drawn; made during set-up
    faults/<kind>.py    Faults(params, G, P, k, seed, device) with a
                        `period` in rounds and at(round_no) ->
                        (crashed bool[P, G] or None, reset bool[G] or None,
                        incident); and a module flag `resets`, true where
                        a reset takes a group's commit back
    confchanges/<kind>.py
                        ConfChanges(params, G, P, k, seed, device) with a
                        `period` in rounds and at(round_no) -> None or the
                        block's requests (start bool[G], voter, outgoing,
                        learner bool[K, P, G]): the groups whose chain of
                        K conf changes starts with this block, and each
                        step's target configuration; made during set-up

A block is k protocol rounds with one crash mask and one append row; the
blocks take the rows in turn.  The traffic's period is the least common
multiple of its kinds' periods.  A new mix of existing kinds is a traffic
file alone; a new kind is a new module.  The same seed gives the same
inputs.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from . import spec


class ConfChangeRequest(NamedTuple):
    """The chains of conf changes that start with a block: PD's operators
    in plain masks (reference/confchange.py runs them)."""

    start: torch.Tensor  # bool[G]: the groups whose chain starts
    voter: torch.Tensor  # bool[K, P, G]: each step's incoming voters
    outgoing: torch.Tensor  # bool[K, P, G]: its outgoing voters (joint)
    learner: torch.Tensor  # bool[K, P, G]: its learners


class BlockInputs(NamedTuple):
    crashed: torch.Tensor  # bool[P, G]
    append: torch.Tensor  # int32[G]
    table: int  # which append row
    reset: Optional[torch.Tensor]  # bool[G]: groups restarted from their initial state first
    incident: bool  # a fault starts with this block
    confchanges: Optional[ConfChangeRequest] = None  # chains that start with it


class Traffic:
    """Block inputs for one run: `block(round_no)` for the block that starts
    at window round `round_no` (a multiple of k)."""

    def __init__(self, tspec: dict, n_groups: int, n_peers: int, k: int, seed: int,
                 device, package: Path = spec.PACKAGE):
        self.k = k
        app = tspec["appends"]
        self.tables = spec.module(package, "appends", app["dist"]).rows(
            app, n_groups, seed, device)
        self.none = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=device)
        f = tspec.get("faults")
        self.faults = None
        self.resets = False
        self.period = k
        if f is not None:
            kind = spec.module(package, "faults", f["kind"])
            self.faults = kind.Faults(f, n_groups, n_peers, k, seed, device)
            self.resets = kind.resets
            self.period = self.faults.period
        if self.period % k:
            raise ValueError(f"the fault period {self.period} is not a multiple of k = {k}")
        c = tspec.get("confchanges")
        self.confchanges = None
        if c is not None:
            self.confchanges = spec.module(package, "confchanges", c["kind"]).ConfChanges(
                c, n_groups, n_peers, k, seed, device)
            if self.confchanges.period % k:
                raise ValueError(f"the conf-change period {self.confchanges.period} is "
                                 f"not a multiple of k = {k}")
            self.period = math.lcm(self.period, self.confchanges.period)

    def block(self, round_no: int) -> BlockInputs:
        table = (round_no // self.k) % self.tables.shape[0]
        append = self.tables[table]
        req = None
        if self.confchanges is not None:
            req = self.confchanges.at(round_no)
            req = None if req is None else ConfChangeRequest(*req)
        if self.faults is None:
            return BlockInputs(self.none, append, table, None, False, req)
        crashed, reset, incident = self.faults.at(round_no)
        return BlockInputs(self.none if crashed is None else crashed, append, table, reset,
                           incident, req)
