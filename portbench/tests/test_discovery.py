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


# A conf-change kind written as a new file: one move chain on every group
# in the first period, PD's move-peer from slot `source` to the empty slot
# `target` (add a learner, enter joint promoting it and demoting the
# source, leave joint, remove the source).
MOVE_ONCE = '''
import torch


class ConfChanges:
    def __init__(self, params, n_groups, n_peers, k, seed, device):
        self.period = params["every_rounds"]
        self.G, self.P, self.device = n_groups, n_peers, device
        v, l = set(params["voters"]), set(params["learners"])
        s, t = params["source"], params["target"]
        inc = (v - {s}) | {t}
        chain = [(v, set(), l | {t}), (inc, v, l), (inc, set(), l | {s}), (inc, set(), l)]
        self.request = (torch.ones(n_groups, dtype=torch.bool, device=device),) + tuple(
            torch.stack([self.mask(step[i]) for step in chain]) for i in range(3))

    def mask(self, slots):
        m = torch.zeros((self.P, self.G), dtype=torch.bool, device=self.device)
        for s in slots:
            m[s - 1] = True
        return m

    def at(self, round_no):
        return None if round_no else self.request
'''


def learner_config(P=5, **kw):
    conf = json.loads((PKG / "configs" / "raftrs-1m-r3.json").read_text())
    conf.update(n_peers=P, voters=[1, 2, 3], learners=[4], system="reconfig_runner",
                deployment="three voters, a learner and an empty slot", **kw)
    return json.dumps(conf)


def test_a_learner_configuration_settles_and_runs_correct(bench_copy):
    root = bench_copy(
        files={"configs/raftrs-r5-learner.json": learner_config()},
        configs=[{"name": "raftrs-r5-learner", "source": "https://example.org/l",
                  "file": "portbench/configs/raftrs-r5-learner.json", "reduced": [],
                  "why": "a learner"}],
        workloads=[{"name": "raftrs-r5-learner.ycsb", "config": "raftrs-r5-learner",
                    "traffic": "ycsb", "chips": 1, "why": "a test cell"}])
    r = harness.run_cell("raftrs-r5-learner.ycsb", 12, 0.3, False, t0=time.perf_counter(),
                         root=root, device="cpu", n_groups=64, sampled_blocks=10**6)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["entries_gap"]["value"] == 0


def test_membership_and_a_conf_change_kind_as_files(bench_copy):
    before = digests(PKG.parent)
    root = bench_copy(
        files={"configs/raftrs-r5-learner.json": learner_config(),
               "confchanges/move_once.py": MOVE_ONCE,
               "traffic/ycsb-move.json": json.dumps({
                   "appends": spec.traffic("ycsb")["appends"],
                   "faults": None,
                   "confchanges": {"kind": "move_once", "every_rounds": 64,
                                   "voters": [1, 2, 3], "learners": [4], "source": 1,
                                   "target": 5}})},
        configs=[{"name": "raftrs-r5-learner", "source": "https://example.org/l",
                  "file": "portbench/configs/raftrs-r5-learner.json", "reduced": [],
                  "why": "a learner"}],
        workloads=[{"name": "raftrs-r5-learner.ycsb-move", "config": "raftrs-r5-learner",
                    "traffic": "ycsb-move", "chips": 1, "why": "a test cell"}])
    after = digests(root)
    assert all(after[p] == h for p, h in before.items())  # nothing edited

    Program = spec.module(root / "portbench", "systems", "reconfig_runner").Program
    ends = []

    class Spy(Program):
        def block(self, st, crashed, append, fused, **cc):
            out = super().block(st, crashed, append, fused, **cc)
            ends.append(out[0])
            return out

    r = harness.run_cell("raftrs-r5-learner.ycsb-move", 13, 0.1, False,
                         t0=time.perf_counter(), root=root, device="cpu", n_groups=64,
                         system=Spy, sampled_blocks=10**6)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["blocks_unchecked"]["value"] == 0
    end = ends[-1]
    # every group moved its replica from slot 1 to slot 5
    assert bool((end.cc_step == 4).all())
    assert end.voter_mask[:, 0].tolist() == [False, True, True, False, True]
    assert end.learner_mask[:, 0].tolist() == [False, False, False, True, False]
    assert bool((end.voter_mask == end.voter_mask[:, :1]).all())
