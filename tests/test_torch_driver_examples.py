"""The port's node examples (raft_tpu_torch/examples/) on the CPU at a small
G: multiraft_node's three in-memory drivers in this process, and
multiraft_tcp's three OS processes on ephemeral localhost ports, the codec
on the wire, under a time limit of its own; each prints the reference's
success line.  run_schedule, the schedule chip_smoke.py drives on the
card, gives the same record twice."""

import os
import subprocess
import sys

import numpy as np

from raft_tpu_torch.examples import multiraft_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multiraft_node_example(capsys):
    assert multiraft_node.main(["--groups", "24", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all 24 groups elected after" in out
    assert out.rstrip().endswith("multiraft_node OK")


def test_run_schedule_is_deterministic():
    a, b = (multiraft_node.run_schedule(12, "cpu", steady_ticks=8)["record"]
            for _ in range(2))
    assert a["active"] == b["active"] and a["elect_ticks"] == b["elect_ticks"]
    assert a["status"] == b["status"]
    for id in multiraft_node.PEERS:
        np.testing.assert_array_equal(a["rows"][id], b["rows"][id])
    # Every group elected, and its proposal committed on every peer.
    assert sum(s["n_leaders"] for s in a["status"].values()) == 12
    assert min(int(a["rows"][id][:, 3].min()) for id in multiraft_node.PEERS) >= 2


def test_multiraft_tcp_example():
    res = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.examples.multiraft_tcp",
         "--groups", "8", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "multiraft_tcp OK: 8 groups across 3 processes" in res.stdout
