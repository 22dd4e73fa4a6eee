"""Sharded-vs-unsharded golden-corpus parity report, counterpart of
`tools/sharded_parity_report.py` on the port.

Replays every scenario of the chaos corpus (tests/testdata/chaos/
plans.json) and the reconfig corpus (tests/testdata/reconfig/plans.json)
twice: once through ClusterSim(mesh=) on N ranks (sharding.launch: the
sharded bootstrap, the whole-batch schedules placed block by block, the
cross-rank reductions) and once unsharded, and requires bit-identity:
every SimState plane, the health planes, and the full scenario report
(MTTR, op-protocol counts, safety counts).  Any divergence, and any
nonzero safety count in either run, exits 2.

    {"groups": 64, "n_devices": 2, "ok": true,
     "chaos": {"symmetric-split": {"match": true, "safety_clean": true,
               "mttr_rounds": ...}, ...},
     "reconfig": {...}}

The module also holds `replay`, the worker that drives one ClusterSim
(sharded on a rank, or not) through a list of operations and returns the
whole batch's planes and results: the sharded tests run it on spawned
ranks, which import this module and never the JAX package.

Usage:  python -m raft_tpu_torch.tools.sharded_parity_report [--groups N]
        [--ranks N] [--out FILE] [--device cpu]

Runs on the CUDA card unless --device says otherwise: with one card its
ranks share it over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TESTDATA = os.path.join(REPO, "tests", "testdata")


def _np(t):
    return None if t is None else t.cpu().numpy()


def replay(mesh, spec: dict, device=None) -> dict:
    """Build ClusterSim(SimConfig(**spec["cfg"])) (with spec["masks"], the
    whole-batch voter/outgoing/learner numpy masks or None, and
    spec["chaos"], a chaos plan dict or None) on `mesh` (a rank's
    sharding.Mesh, or None for the unsharded sim on `device`) and run
    spec["ops"] in order, each a tuple:

      ("run_compiled", rounds, append)       append int32[G] numpy or None
      ("run_round", crashed, append, link)   whole-batch numpy planes or None
      ("run_plan",)
      ("run_reconfig", plan, chaos, kw)      plan dicts (chaos may be None)
      ("run_reads", plan, chaos, reconfig, kw)
      ("counters",) / ("health",) / ("forensics",)
      ("status",)                            sharding.global_status (None
                                             unsharded)
      ("sharded_step", rounds, append)       sharding.sharded_step, `rounds`
                                             times (sim.step unsharded)
      ("sharded_read_index",)                sharding.sharded_read_index's
                                             whole batch (sim.read_index
                                             unsharded), a list
      ("run_sharded", rounds)                sharding.run_sharded's status
                                             (its state becomes the sim's)
      ("read_index",)                        the whole batch's, a list
      ("set_state", arrays)                  a whole-batch state_to_numpy

    Returns {"state", "health", "blackbox", "results"}: the whole batch's
    SimState planes (numpy, by field), health planes, black-box planes and
    each operation's result, the same on every rank."""
    import torch

    from ..multiraft import chaos, reconfig, sharding, sim, workload

    cfg = sim.SimConfig(**spec["cfg"])
    G = cfg.n_groups
    masks = [None if m is None else torch.from_numpy(np.asarray(m))
             for m in (spec.get("masks") or (None, None, None))]
    plan = spec.get("chaos")
    cs = sim.ClusterSim(
        cfg, *masks, chaos=None if plan is None else chaos.plan_from_dict(plan),
        mesh=mesh, device=None if mesh is not None else device,
    )

    def t(x, dtype):
        return None if x is None else torch.from_numpy(np.asarray(x)).to(dtype)

    def whole(x):
        return x if mesh is None else sharding.gather_groups(mesh, x, G)

    results = []
    for op in spec["ops"]:
        name, args = op[0], op[1:]
        if name == "run_compiled":
            cs.run_compiled(args[0], append_n=t(args[1], torch.int32))
            res = None
        elif name == "run_round":
            cs.run_round(t(args[0], torch.bool), t(args[1], torch.int32),
                         t(args[2], torch.bool))
            res = None
        elif name == "run_plan":
            res = cs.run_plan()
        elif name == "run_reconfig":
            cplan = None if args[1] is None else chaos.plan_from_dict(args[1])
            res = cs.run_reconfig(reconfig.plan_from_dict(args[0]),
                                  chaos_plan=cplan, **args[2])
        elif name == "run_reads":
            cplan = None if args[1] is None else chaos.plan_from_dict(args[1])
            rplan = None if args[2] is None else reconfig.plan_from_dict(args[2])
            res = cs.run_reads(workload.plan_from_dict(args[0]), chaos_plan=cplan,
                               reconfig_plan=rplan, **args[3])
        elif name == "counters":
            res = cs.counters()
        elif name == "health":
            res = cs.health()
        elif name == "forensics":
            res = cs.forensics()
        elif name == "status":
            res = None if mesh is None else sharding.global_status(cs.cfg, mesh)(cs.state)
        elif name == "sharded_step":
            fn = (sharding.sharded_step(cfg, mesh) if mesh is not None
                  else lambda st, c, a: sim.step(cs.cfg, st, c, a))
            crashed = torch.zeros((cfg.n_peers, G), dtype=torch.bool)
            for _ in range(args[0]):
                cs.state = fn(cs.state, crashed.to(cs.device),
                              t(args[1], torch.int32).to(cs.device))
            res = None
        elif name == "sharded_read_index":
            crashed = torch.zeros((cfg.n_peers, G), dtype=torch.bool, device=cs.device)
            if mesh is None:
                res = sim.read_index(cfg, cs.state, crashed).tolist()
            else:
                res = whole(sharding.sharded_read_index(cfg, mesh)(cs.state, crashed)).tolist()
        elif name == "run_sharded":
            cs.state, res = sharding.run_sharded(cfg, mesh, args[0])
        elif name == "read_index":
            res = whole(cs.read_index()).tolist()
        elif name == "set_state":
            st = sim.state_from_numpy(args[0], device=cs.device)
            cs.state = st if mesh is None else sharding.shard_state(st, mesh)
            res = None
        else:
            raise ValueError(f"unknown operation {name!r}")
        results.append(res)
    st = cs.state if mesh is None else sharding.gather_state(mesh, cs.state, G)
    out = {"state": sim.state_to_numpy(st), "health": None, "blackbox": None,
           "results": results}
    if cs._health is not None:
        out["health"] = _np(whole(cs._health.planes))
    if cs._blackbox is not None:
        bb = cs._blackbox
        out["blackbox"] = {f: _np(whole(getattr(bb, f)))
                           for f in ("meta", "term", "commit", "trip_round")}
        out["blackbox"]["round_idx"] = int(bb.round_idx)
    return out


def replay_each(mesh, specs: list, device=None) -> list:
    """replay() of each spec in turn, on one sim each."""
    return [replay(mesh, spec, device) for spec in specs]


def diff(a: dict, b: dict) -> list:
    """The names of what differs between two replay() outputs: state
    fields, "health", black-box planes and "results"."""
    out = []
    for name in sorted(set(a["state"]) | set(b["state"])):
        x, y = a["state"].get(name), b["state"].get(name)
        if x is None or y is None or not np.array_equal(x, y):
            out.append(name)
    for key in ("health",):
        x, y = a[key], b[key]
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            out.append(key)
    if (a["blackbox"] is None) != (b["blackbox"] is None):
        out.append("blackbox")
    elif a["blackbox"] is not None:
        for f, x in a["blackbox"].items():
            if not np.array_equal(x, b["blackbox"][f]):
                out.append(f"blackbox.{f}")
    if a["results"] != b["results"]:
        out.append("results")
    return out


def _corpus(name: str) -> list:
    with open(os.path.join(TESTDATA, name, "plans.json"), encoding="utf-8") as f:
        return json.load(f)


def scenario_specs(groups: int) -> dict:
    """{corpus: {scenario: replay spec}} for both golden corpora at
    `groups` groups."""
    from ..multiraft import reconfig

    specs = {"chaos": {}, "reconfig": {}}
    for doc in _corpus("chaos"):
        specs["chaos"][doc["name"]] = {
            "cfg": dict(n_groups=groups, n_peers=int(doc["peers"]), collect_health=True),
            "chaos": doc, "ops": [("run_plan",)],
        }
    for doc in _corpus("reconfig"):
        plan = reconfig.plan_from_dict(doc["reconfig"])
        masks = [m.numpy() for m in reconfig.initial_masks(plan, groups, "cpu")]
        specs["reconfig"][plan.name] = {
            "cfg": dict(n_groups=groups, n_peers=plan.n_peers, collect_health=True),
            "masks": masks,
            "ops": [("run_reconfig", doc["reconfig"], doc["chaos"], {})],
        }
    return specs


def replay_all(mesh, specs: dict, device=None) -> dict:
    """replay() of every spec of scenario_specs, keyed the same way."""
    return {corpus: {name: replay(mesh, spec, device) for name, spec in runs.items()}
            for corpus, runs in specs.items()}


def _pair_result(a: dict, b: dict) -> dict:
    diverged = diff(a, b)
    report = a["results"][-1]
    out = {
        "match": not diverged,
        "safety_clean": not any(report.get("safety", {"x": 1}).values()),
        "mttr_rounds": report.get("mttr_rounds"),
    }
    if diverged:
        out["diverged"] = diverged
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--groups", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", default="", metavar="FILE")
    ap.add_argument("--device", default=None,
                    help="cpu for CPU ranks; default the CUDA card (ranks share it)")
    args = ap.parse_args(argv)

    from ..multiraft import sharding
    from ..multiraft.platform import resolve_device

    dev = resolve_device(args.device)
    specs = scenario_specs(args.groups)
    devices = [dev] * args.ranks
    sharded = sharding.launch(args.ranks, replay_all, specs, devices=devices)
    local = replay_all(None, specs, dev)
    report = {"groups": args.groups, "n_devices": args.ranks}
    bad = []
    for corpus in ("chaos", "reconfig"):
        report[corpus] = {}
        for name in specs[corpus]:
            res = _pair_result(sharded[corpus][name], local[corpus][name])
            report[corpus][name] = res
            if not res["match"]:
                bad.append(f"{corpus}/{name}: sharded run DIVERGED on {res.get('diverged')}")
            if not res["safety_clean"]:
                bad.append(f"{corpus}/{name}: nonzero safety counts")
    report["ok"] = not bad
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(report["chaos"], sort_keys=True))
    print(json.dumps(report["reconfig"], sort_keys=True))
    for msg in bad:
        print(f"ERROR: {msg}", file=sys.stderr)
    return 2 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
