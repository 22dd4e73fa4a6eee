"""A multi-host-shaped multi-raft deployment on the port: three OS
processes, each a MultiRaft driver hosting the same groups, exchanging
group-tagged wire messages over TCP.

Counterpart of `examples/multiraft_tcp.py`: per-process device-batched
ticking, per-destination message batching, and the binary codec on the
wire (frame = u32 len | u32 group | codec message).  Each node listens on
an ephemeral localhost port, and the parent hands every node the others'
ports before any message moves.

Run: python -m raft_tpu_torch.examples.multiraft_tcp [--groups G]
[--device cpu]
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import queue
import socket
import struct
import threading
import time
from typing import List, Optional

NUM_NODES = 3
DEFAULT_GROUPS = 64
PROPOSALS_PER_GROUP = 3
NODE_DEADLINE_S = 120


def node_main(node_id, n_groups, device, port_q, ports_q, result_q):
    from ..multiraft.driver import MultiRaft
    from ..scalar.codec import decode_message, encode_message
    from ..scalar.config import Config
    from ..scalar.raft import StateRole
    from ..scalar.raft_log import NO_LIMIT
    from ..scalar.storage import MemStorage

    peers = list(range(1, NUM_NODES + 1))
    storages = [MemStorage.new_with_conf_state((peers, [])) for _ in range(n_groups)]
    cfg = Config(
        id=node_id,
        election_tick=10,
        heartbeat_tick=3,
        max_size_per_msg=NO_LIMIT,
        max_inflight_msgs=256,
    )
    driver = MultiRaft(cfg, storages, device=device)

    inbox = queue.Queue()

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(NUM_NODES)
    port_q.put((node_id, server.getsockname()[1]))
    ports = ports_q.get(timeout=60)  # {node id: port}, every node's

    def reader(conn):
        try:
            while True:
                hdr = conn.recv(8, socket.MSG_WAITALL)
                if len(hdr) < 8:
                    return
                n, g = struct.unpack("<II", hdr)
                buf = b""
                while len(buf) < n:
                    chunk = conn.recv(n - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                inbox.put((g, decode_message(buf)))
        except OSError:
            pass

    def acceptor():
        while True:
            try:
                conn, _ = server.accept()
            except OSError:
                return
            threading.Thread(target=reader, args=(conn,), daemon=True).start()

    threading.Thread(target=acceptor, daemon=True).start()

    out_conns = {}

    def send_batch(to, batch):
        conn = out_conns.get(to)
        if conn is None:
            try:
                conn = socket.create_connection(("127.0.0.1", ports[to]), timeout=1)
                out_conns[to] = conn
            except OSError:
                return
        frames = []
        for g, m in batch:
            payload = encode_message(m)
            frames.append(struct.pack("<II", len(payload), g) + payload)
        try:
            conn.sendall(b"".join(frames))
        except OSError:
            out_conns.pop(to, None)

    applied = {}  # group -> count
    proposed = {}  # group -> count
    tick_interval = 0.02
    last_tick = time.monotonic()
    deadline = time.monotonic() + NODE_DEADLINE_S
    while time.monotonic() < deadline:
        # Drain the network inbox in one batched delivery.
        batch = []
        try:
            while True:
                batch.append(inbox.get_nowait())
        except queue.Empty:
            pass
        if batch:
            driver.step_batch(batch)

        now = time.monotonic()
        if now - last_tick >= tick_interval:
            driver.tick()
            last_tick = now

        # The leader of each group drives its workload.
        for g in range(n_groups):
            node = driver.node(g)
            if (
                node.raft.state == StateRole.Leader
                and proposed.get(g, 0) < PROPOSALS_PER_GROUP
                and node.raft.raft_log.committed
                >= node.raft.raft_log.last_index()
            ):
                driver.propose(g, b"", b"x")
                proposed[g] = proposed.get(g, 0) + 1

        # Ready processing with per-destination outboxes.
        outbox = {}
        for g in driver.ready_groups():
            rd = driver.ready(g)
            node = driver.node(g)
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
            committed = rd.take_committed_entries()
            light = driver.advance(g, rd)
            msgs += light.take_messages()
            committed += light.take_committed_entries()
            for e in committed:
                if e.data:
                    applied[g] = applied.get(g, 0) + 1
            driver.advance_apply(g)
            for m in msgs:
                outbox.setdefault(m.to, []).append((g, m))
        for to, batch in outbox.items():
            send_batch(to, batch)

        if sum(applied.values()) >= n_groups * PROPOSALS_PER_GROUP:
            break
        time.sleep(0.001)

    status = driver.status()
    result_q.put((node_id, sum(applied.values()), status["n_leaders"]))
    server.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=DEFAULT_GROUPS)
    ap.add_argument("--device", default=None,
                    help="torch device of each node's tick (default: the CUDA card)")
    opts = ap.parse_args(argv)
    G = opts.groups
    ctx = mp.get_context("spawn")
    port_q, result_q = ctx.Queue(), ctx.Queue()
    ports_qs = {i: ctx.Queue() for i in range(1, NUM_NODES + 1)}
    procs = [
        ctx.Process(target=node_main, daemon=True,
                    args=(i, G, opts.device, port_q, ports_qs[i], result_q))
        for i in range(1, NUM_NODES + 1)
    ]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        ports = dict(port_q.get(timeout=120) for _ in range(NUM_NODES))
        for q in ports_qs.values():
            q.put(ports)
        total_applied = 0
        total_leaders = 0
        for _ in range(NUM_NODES):
            node_id, applied, leaders = result_q.get(timeout=NODE_DEADLINE_S + 30)
            print(f"node {node_id}: applied {applied} entries, leads {leaders} groups")
            total_applied += applied
            total_leaders += leaders
        for p in procs:
            p.join(timeout=10)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    dt = time.monotonic() - t0
    assert total_leaders == G, f"leaders: {total_leaders}"
    assert total_applied >= G * PROPOSALS_PER_GROUP
    print(
        f"multiraft_tcp OK: {G} groups across 3 processes, "
        f"{G * PROPOSALS_PER_GROUP} entries committed over TCP in {dt:.1f}s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
