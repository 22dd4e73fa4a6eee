"""A TiKV-style multi-raft node hosting thousands of groups, on the port.

Counterpart of `examples/multiraft_node.py`.  Three MultiRaft drivers (one
per peer id) tick their groups with one device round trip per tick each;
the host only touches groups whose timers fired.  Messages route between
drivers through in-memory batched inboxes (the production analog batches
per destination host).

Run: python -m raft_tpu_torch.examples.multiraft_node [--groups G]
[--device cpu]

`run_schedule` is the fixed schedule `chip_smoke.py` drives on the card
and on the CPU: elect every group, propose one entry in each on its
leader's driver, then tick and pump a number of steady ticks.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from ..multiraft.driver import MultiRaft
from ..scalar.config import Config
from ..scalar.raft import StateRole
from ..scalar.raft_log import NO_LIMIT
from ..scalar.storage import MemStorage

DEFAULT_GROUPS = 2_000
PEERS = [1, 2, 3]
ELECT_CAP = 200  # ticks


def base_config(id, metrics=None):
    return Config(
        id=id,
        election_tick=10,
        heartbeat_tick=3,
        max_size_per_msg=NO_LIMIT,
        max_inflight_msgs=256,
        metrics=metrics,
    )


def build(n_groups: int, device=None, metrics=None) -> Dict[int, MultiRaft]:
    """One MultiRaft driver per peer id, each hosting `n_groups` groups on
    MemStorage; `metrics` (one Metrics, or None) is shared by all three."""
    drivers = {}
    for id in PEERS:
        storages = [MemStorage.new_with_conf_state((PEERS, [])) for _ in range(n_groups)]
        drivers[id] = MultiRaft(base_config(id, metrics), storages, device=device)
    return drivers


def pump(drivers: Dict[int, MultiRaft]) -> None:
    """Run every ready group's Ready cycle and deliver the messages, batched
    per destination driver, until no driver has readiness or mail."""
    moved = True
    while moved:
        moved = False
        outbox = []
        for id, d in drivers.items():
            for g in d.ready_groups():
                rd = d.ready(g)
                node = d.node(g)
                store = node.raft.raft_log.store
                msgs = rd.take_messages()
                with store.wl() as core:
                    if not rd.snapshot.is_empty():
                        core.apply_snapshot(rd.snapshot.clone())
                    if rd.entries:
                        core.append(rd.entries)
                    if rd.hs is not None:
                        core.set_hardstate(rd.hs.clone())
                msgs += rd.persisted_messages()
                light = d.advance(g, rd)
                msgs += light.take_messages()
                d.advance_apply(g)
                outbox.extend((g, m) for m in msgs)
                moved = True
        by_dest = {}
        for g, m in outbox:
            by_dest.setdefault(m.to, []).append((g, m))
        for to, batch in by_dest.items():
            drivers[to].step_batch(batch)
            moved = True


def n_leaders(drivers: Dict[int, MultiRaft]) -> int:
    return sum(d.status()["n_leaders"] for d in drivers.values())


def elect(drivers: Dict[int, MultiRaft], n_groups: int, tick) -> int:
    """Call tick() (a tick of every driver and a pump) until every group
    has a leader; the ticks it took (at most ELECT_CAP, else raise)."""
    ticks = 0
    while n_leaders(drivers) != n_groups:
        if ticks == ELECT_CAP:
            raise RuntimeError(f"elections incomplete after {ELECT_CAP} ticks: "
                               f"{n_leaders(drivers)}/{n_groups}")
        tick()
        ticks += 1
    return ticks


def group_rows(d: MultiRaft) -> np.ndarray:
    """int64 [G, 5]: each group's (term, state, leader_id, committed,
    last_index) on driver `d`."""
    return np.array([
        (n.raft.term, int(n.raft.state), n.raft.leader_id,
         n.raft.raft_log.committed, n.raft.raft_log.last_index())
        for n in d.nodes
    ], dtype=np.int64).reshape(-1, 5)


def run_schedule(n_groups: int, device=None, metrics=None,
                 steady_ticks: int = 32) -> dict:
    """The fixed schedule: tick and pump until every group has a leader
    (at most ELECT_CAP ticks), propose one entry in every group on its
    leader's driver, then `steady_ticks` ticks with a pump after each.

    Returns the deterministic record (the active count of every driver
    tick, the ticks to elect, each driver's group rows and status() without
    its metrics entry) and the wall seconds of the election and the steady
    ticks."""
    drivers = build(n_groups, device, metrics)
    active: List[int] = []

    def tick_all():
        for d in drivers.values():
            active.append(int(d.tick().sum()))
        pump(drivers)

    t0 = time.perf_counter()
    ticks = elect(drivers, n_groups, tick_all)
    elect_s = time.perf_counter() - t0
    for d in drivers.values():
        for g, node in enumerate(d.nodes):
            if node.raft.state == StateRole.Leader:
                d.propose(g, b"", b"x")
    pump(drivers)
    t0 = time.perf_counter()
    for _ in range(steady_ticks):
        tick_all()
    steady_s = time.perf_counter() - t0
    status = {}
    for id, d in drivers.items():
        st = d.status()
        st.pop("metrics", None)
        status[id] = st
    return {
        "record": {
            "active": active,
            "elect_ticks": ticks,
            "rows": {id: group_rows(d) for id, d in drivers.items()},
            "status": status,
        },
        "elect_s": elect_s,
        "steady_s": steady_s,
        "drivers": drivers,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=DEFAULT_GROUPS)
    ap.add_argument("--device", default=None,
                    help="torch device of the tick (default: the CUDA card)")
    opts = ap.parse_args(argv)
    G = opts.groups

    t0 = time.monotonic()
    drivers = build(G, opts.device)
    print(f"built 3 nodes x {G} groups in {time.monotonic() - t0:.1f}s")

    # Tick until every group has elected a leader.
    t0 = time.monotonic()

    def tick_all():
        for d in drivers.values():
            d.tick()
        pump(drivers)

    ticks = elect(drivers, G, tick_all)
    dt = time.monotonic() - t0
    print(
        f"all {G} groups elected after {ticks} ticks in {dt:.1f}s "
        f"({ticks * G * len(PEERS) / dt:,.0f} group-ticks/sec incl. election traffic)"
    )

    # Steady state: ticks are now nearly free on the host.
    t0 = time.monotonic()
    for _ in range(5):
        tick_all()
    dt = time.monotonic() - t0
    print(f"5 steady ticks across 3x{G} groups in {dt:.2f}s")

    status = drivers[1].status()
    print("node 1 status:", status)
    assert n_leaders(drivers) == G
    print("multiraft_node OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
