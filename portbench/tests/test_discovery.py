"""A new configuration, traffic mix, append distribution, fault kind, cell or
per-layer metric is found from new files and BENCHMARK.json entries alone,
with no existing file edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from portbench import harness, spec

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent

# A fault kind written as a new file: one peer of every group is crashed
# for `down_rounds` of every `every_rounds` rounds, the peer turning round.
PEER_DOWN = '''
resets = False


class Faults:
    def __init__(self, params, n_groups, n_peers, k, seed, device):
        import torch
        self.period, self.down, self.P = params["every_rounds"], params["down_rounds"], n_peers
        self.masks = torch.eye(n_peers, dtype=torch.bool, device=device)[:, :, None].expand(
            n_peers, n_peers, n_groups)

    def at(self, round_no):
        pos = round_no % self.period
        crashed = self.masks[(round_no // self.period) % self.P] if pos < self.down else None
        return crashed, None, pos == 0
'''

# An append distribution written as a new file: every group proposes
# `entries` a round.
UNIFORM = '''
import torch


def rows(params, n_groups, seed, device):
    return torch.full((1, n_groups), params["entries"], dtype=torch.int32, device=device)
'''


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_kinds_cell_and_metric_as_files(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(tmp_path)
    new = tmp_path / "portbench"

    conf = json.loads((PKG / "configs" / "raftrs-1m-r3.json").read_text())
    conf.update(n_peers=5, deployment="a five-voter fleet")
    (new / "configs" / "raftrs-r5.json").write_text(json.dumps(conf))
    (new / "faults" / "peer_down.py").write_text(PEER_DOWN)
    (new / "appends" / "uniform.py").write_text(UNIFORM)
    (new / "traffic" / "uniform-peer-down.json").write_text(json.dumps({
        "appends": {"dist": "uniform", "entries": 2},
        "faults": {"kind": "peer_down", "every_rounds": 128, "down_rounds": 32}}))
    (new / "metrics" / "general_blocks.py").write_text(
        "def read(ctx):\n    return sum(not b.fused for b in ctx.blocks)\n")
    bench["configs"].append({"name": "raftrs-r5", "source": "https://example.org/r5",
                             "file": "portbench/configs/raftrs-r5.json", "reduced": [],
                             "why": "five voters"})
    cell = "raftrs-r5.uniform-peer-down"
    bench["workloads"].append({"name": cell, "config": "raftrs-r5",
                               "traffic": "uniform-peer-down", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "general_blocks", "unit": "blocks", "better": "lower",
                               "source": "host_clock", "layer": "dispatch",
                               "moves": "ticks_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(tmp_path)
    assert all(after[p] == h for p, h in before.items())  # nothing edited

    assert spec.cell(spec.load_benchmark(tmp_path), cell)["traffic"] == "uniform-peer-down"
    kw = dict(t0=time.perf_counter(), root=tmp_path, device="cpu", n_groups=200)
    r = harness.run_cell(cell, 11, 0.5, True, **kw)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    # the new fault kind ran: leaders went down, so some blocks ran general
    assert 0 < r["metrics"]["general_blocks"]["value"] < r["attempted"]
    assert "fused_pct" not in r["metrics"]  # not listed for the new cell
