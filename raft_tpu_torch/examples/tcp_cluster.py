"""A three-process raft cluster over real TCP sockets on the port's scalar
core, counterpart of `examples/tcp_cluster.py`.

Demonstrates the transport seam the reference leaves to the application
(reference: README.md "Transport ... you will need to build your own"):
each node runs in its own OS process, exchanges length-prefixed
`raft_tpu_torch.scalar.codec`-encoded messages over localhost TCP, drives
the Ready protocol against a MemStorage, and applies committed entries to
a toy state machine.  Each node listens on an ephemeral localhost port,
and the parent hands every node the others' ports before any message
moves.

Run: python -m raft_tpu_torch.examples.tcp_cluster
"""

import multiprocessing as mp
import queue
import socket
import struct
import threading
import time

NUM_NODES = 3
NUM_PROPOSALS = 20


def node_main(node_id: int, port_q, ports_q, result_q):
    from ..scalar import Config, MemStorage, Message, RawNode, StateRole
    from ..scalar.codec import decode_message, encode_message

    storage = MemStorage.new_with_conf_state((list(range(1, NUM_NODES + 1)), []))
    cfg = Config(
        id=node_id,
        election_tick=10,
        heartbeat_tick=3,
        max_size_per_msg=1024 * 1024,
        max_inflight_msgs=256,
    )
    node = RawNode(cfg, storage)

    inbox: "queue.Queue[Message]" = queue.Queue()

    # --- transport: one listener + lazy outbound connections ---
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(NUM_NODES)
    port_q.put((node_id, server.getsockname()[1]))
    ports = ports_q.get(timeout=60)  # {node id: port}, every node's

    def reader(conn):
        try:
            while True:
                hdr = conn.recv(4, socket.MSG_WAITALL)
                if len(hdr) < 4:
                    return
                (n,) = struct.unpack("<I", hdr)
                buf = b""
                while len(buf) < n:
                    chunk = conn.recv(n - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                inbox.put(decode_message(buf))
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

    def send(m: Message):
        to = m.to
        conn = out_conns.get(to)
        if conn is None:
            try:
                conn = socket.create_connection(
                    ("127.0.0.1", ports[to]), timeout=1
                )
                out_conns[to] = conn
            except OSError:
                return  # peer not up yet; raft will retry
        payload = encode_message(m)
        try:
            conn.sendall(struct.pack("<I", len(payload)) + payload)
        except OSError:
            out_conns.pop(to, None)

    # --- the event loop ---
    kv = {}
    proposed = 0
    tick_interval = 0.02
    last_tick = time.monotonic()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            while True:
                node.step(inbox.get_nowait())
        except queue.Empty:
            pass
        except Exception:
            pass

        now = time.monotonic()
        if now - last_tick >= tick_interval:
            node.tick()
            last_tick = now

        # the leader proposes the workload
        if (
            node.raft.state == StateRole.Leader
            and proposed < NUM_PROPOSALS
            and node.raft.raft_log.committed >= node.raft.raft_log.last_index()
        ):
            node.propose(b"", f"key{proposed}={proposed}".encode())
            proposed += 1

        if node.has_ready():
            rd = node.ready()
            for m in rd.take_messages():
                send(m)
            with storage.wl() as core:
                if not rd.snapshot.is_empty():
                    core.apply_snapshot(rd.snapshot.clone())
                if rd.entries:
                    core.append(rd.entries)
                if rd.hs is not None:
                    core.set_hardstate(rd.hs.clone())
            for m in rd.take_persisted_messages():
                send(m)
            committed = rd.take_committed_entries()
            light = node.advance(rd)
            committed.extend(light.take_committed_entries())
            for m in light.take_messages():
                send(m)
            for e in committed:
                if e.data:
                    k, v = e.data.decode().split("=", 1)
                    kv[k] = v
            node.advance_apply()

        if len(kv) == NUM_PROPOSALS:
            break
        time.sleep(0.001)

    result_q.put((node_id, len(kv), node.raft.raft_log.committed))
    server.close()


def main():
    ctx = mp.get_context("spawn")
    port_q, result_q = ctx.Queue(), ctx.Queue()
    ports_qs = {i: ctx.Queue() for i in range(1, NUM_NODES + 1)}
    procs = [
        ctx.Process(target=node_main, args=(i, port_q, ports_qs[i], result_q),
                    daemon=True)
        for i in range(1, NUM_NODES + 1)
    ]
    for p in procs:
        p.start()
    results = {}
    try:
        ports = dict(port_q.get(timeout=60) for _ in range(NUM_NODES))
        for q in ports_qs.values():
            q.put(ports)
        for _ in range(NUM_NODES):
            node_id, applied, committed = result_q.get(timeout=90)
            results[node_id] = (applied, committed)
            print(f"node {node_id}: applied {applied} entries, commit={committed}")
        for p in procs:
            p.join(timeout=10)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert all(applied == NUM_PROPOSALS for applied, _ in results.values()), results
    print(f"tcp_cluster OK: {NUM_PROPOSALS} entries replicated over TCP to "
          f"{NUM_NODES} processes")


if __name__ == "__main__":
    main()
