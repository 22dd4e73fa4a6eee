"""The canonical single-node Ready-protocol loop on the port's scalar core,
counterpart of `examples/single_mem_node.py` (reference:
examples/single_mem_node/main.rs — behavioral port).

A one-node raft cluster backed by MemStorage, driven by a timer loop:
proposals arrive through a queue, the Ready protocol persists entries and
applies committed ones to a toy key-value state machine.

Run: python -m raft_tpu_torch.examples.single_mem_node
"""

import queue
import time

from ..scalar import Config, MemStorage, RawNode


def main() -> None:
    # Create the single-node cluster: voter set {1}.
    storage = MemStorage.new_with_conf_state(([1], []))
    cfg = Config(
        id=1,
        election_tick=10,
        heartbeat_tick=3,
        max_size_per_msg=1024 * 1024,
        max_inflight_msgs=256,
        applied=0,
    )
    node = RawNode(cfg, storage)

    # The proposal channel: (key, value) pairs the client wants stored.
    proposals = queue.Queue()  # (key, value) pairs
    kv = {}

    # A client that sends one proposal and waits for it to apply.
    proposals.put((2, "hello"))
    proposals.put((3, "world"))

    tick_interval = 0.01
    last_tick = time.monotonic()
    pending = 0
    while len(kv) < 2:
        # Timer-driven tick (reference: main.rs's 100ms loop).
        now = time.monotonic()
        if now - last_tick >= tick_interval:
            node.tick()
            last_tick = now

        # Propose waiting client requests once a leader exists (a single
        # node elects itself after its randomized election timeout).
        if node.raft.state == 2:  # StateRole.Leader
            try:
                while True:
                    key, value = proposals.get_nowait()
                    node.propose(b"", f"{key}={value}".encode())
                    pending += 1
            except queue.Empty:
                pass

        if not node.has_ready():
            time.sleep(0.001)
            continue

        # The Ready protocol (reference: lib.rs:176-430 walkthrough):
        rd = node.ready()
        # (1) messages would go to peers — single node has none.
        _ = rd.take_messages()
        # (2) apply snapshot / (4) append entries / (5) persist HardState.
        if not rd.snapshot.is_empty():
            with storage.wl() as core:
                core.apply_snapshot(rd.snapshot.clone())
        if rd.entries:
            with storage.wl() as core:
                core.append(rd.entries)
        if rd.hs is not None:
            with storage.wl() as core:
                core.set_hardstate(rd.hs.clone())
        # (6) persisted messages — none on a single node.
        _ = rd.take_persisted_messages()
        # (3, 7) apply committed entries through advance.
        committed = rd.take_committed_entries()
        light = node.advance(rd)
        committed.extend(light.take_committed_entries())
        for entry in committed:
            if entry.data:
                key, value = entry.data.decode().split("=", 1)
                kv[int(key)] = value
                print(f"applied index={entry.index}: kv[{key}] = {value!r}")
        node.advance_apply()

    print("state machine:", dict(sorted(kv.items())))
    assert kv == {2: "hello", 3: "world"}
    print("single_mem_node OK")


if __name__ == "__main__":
    main()
