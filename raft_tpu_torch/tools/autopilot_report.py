"""Before/after autopilot self-healing report over the chaos golden corpus,
counterpart of `tools/autopilot_report.py` on the port.

Runs every scenario in tests/testdata/chaos/plans.json twice through the
IDENTICAL cadence machinery (autopilot.Autopilot over cadence-sized
segments) — once with every action disabled (the baseline replay: with
zero actions the cadence runner is protocol-identical to the plain chaos
runner) and once with the closed loop ON (kick + transfer; evacuation
stays off: the 3-peer corpus has no spare peers) — and writes one JSON
document comparing the runs per scenario::

    {"groups": 64, "cadence": 6, "plans": {
        "asymmetric-link": {
            "off": {"mttr_rounds": ..., "reelections": ...,
                    "leaderless_group_rounds": ...,
                    "commit_stall_group_rounds": ..., "safety": {...}},
            "on":  {..., "actions": {"kicks": n, "transfers": n, ...}},
        }, ...},
     "aggregate": {"off": {...}, "on": {...},
                   "mttr_improvement": ..., "commit_stall_improvement": ...}}

The run exits 2 when ANY safety-invariant count is non-zero in EITHER
configuration, when the autopilot-on aggregate MTTR fails to beat the
autopilot-off replay, or when the aggregate commit-stall group-rounds fail
to improve.  On a nonzero safety count the configuration re-runs with the
black box on and the incident JSON plus the generated repro are written
(forensics.capture_artifacts, through forensics.report_failures).

Usage:  python -m raft_tpu_torch.tools.autopilot_report [--groups N]
        [--cadence K] [--out FILE] [--device cpu]

Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PLANS = os.path.join(REPO, "tests", "testdata", "chaos", "plans.json")

REPORT_KEYS = (
    "mttr_rounds",
    "reelections",
    "leaderless_group_rounds",
    "max_leaderless_streak",
    "commit_stall_group_rounds",
)


def run_config(doc: dict, groups: int, cadence: int, on: bool,
               blackbox: bool = False, device=None) -> "dict | tuple":
    from ..multiraft import ClusterSim, SimConfig, chaos
    from ..multiraft.autopilot import Autopilot, AutopilotConfig

    plan = chaos.plan_from_dict(doc)
    cfg = SimConfig(
        n_groups=groups,
        n_peers=plan.n_peers,
        collect_health=True,
        transfer=True,
        # A tight stall threshold so the commit-stall metric resolves
        # mid-scenario episodes, not only the pathological tails.
        commit_stall_ticks=8,
        blackbox=blackbox,
    )
    sim = ClusterSim(cfg, device=device)
    ap = Autopilot(
        sim,
        AutopilotConfig(
            cadence=cadence,
            kick=on,
            transfer=on,
            evacuate=False,
            kick_leaderless_ticks=2,
            transfer_stall_ticks=6,
        ),
    )
    report = ap.run_plan(plan)
    out = {k: report.get(k) for k in REPORT_KEYS}
    out["safety"] = report["safety"]
    if on:
        out["actions"] = report["actions"]
    if blackbox:
        return out, sim, plan
    return out


def capture_incident(doc: dict, groups: int, cadence: int, on: bool,
                     art_dir: str, name: str, device=None) -> dict:
    """The on-failure hook: re-run the failing configuration with the black
    box on (a pure observer) and write the incident JSON + generated repro;
    the repro replays the chaos fault column (autopilot actions live in the
    incident windows)."""
    from ..multiraft import forensics

    _, sim, plan = run_config(doc, groups, cadence, on, blackbox=True,
                              device=device)
    return forensics.capture_artifacts(
        sim, plan, art_dir, stem=f"incident-{name}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.autopilot_report",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--groups", type=int, default=64)
    ap.add_argument("--cadence", type=int, default=6)
    ap.add_argument("--out", default="autopilot-report.json")
    ap.add_argument(
        "--artifacts-dir",
        default="",
        help="directory for on-failure forensics artifacts (incident "
        "JSON + generated repro); default: the --out directory",
    )
    ap.add_argument("--plans", default=PLANS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..multiraft.platform import resolve_device

    dev = resolve_device(args.device)
    with open(args.plans, "r", encoding="utf-8") as f:
        docs = json.load(f)
    out = {"groups": args.groups, "cadence": args.cadence, "plans": {}}
    failed = []
    to_capture = {}
    agg = {
        side: {k: 0 for k in REPORT_KEYS if k != "mttr_rounds"}
        | {"healed_rounds": 0.0}
        for side in ("off", "on")
    }
    total_actions = 0
    for doc in docs:
        name = doc["name"]
        off = run_config(doc, args.groups, args.cadence, on=False, device=dev)
        on = run_config(doc, args.groups, args.cadence, on=True, device=dev)
        out["plans"][name] = {"off": off, "on": on}
        for side, rep in (("off", off), ("on", on)):
            if any(rep["safety"].values()):
                failed.append(f"{name}/{side}: safety {rep['safety']}")
                to_capture[name] = (doc, side == "on")
            a = agg[side]
            for k in a:
                if k == "healed_rounds":
                    # mean episode length x episodes = total healed rounds
                    if rep["mttr_rounds"] is not None:
                        a[k] += rep["mttr_rounds"] * rep["reelections"]
                elif k == "max_leaderless_streak":
                    a[k] = max(a[k], rep[k])
                else:
                    a[k] += rep[k]
        total_actions += sum(on["actions"].values())
        print(
            f"{name}: mttr {off['mttr_rounds']} -> {on['mttr_rounds']}, "
            f"commit-stall g-rounds {off['commit_stall_group_rounds']} -> "
            f"{on['commit_stall_group_rounds']}, actions {on['actions']}"
        )
    for side in ("off", "on"):
        a = agg[side]
        a["mttr_rounds"] = (
            round(a["healed_rounds"] / a["reelections"], 3)
            if a["reelections"]
            else None
        )
        a["healed_rounds"] = round(a["healed_rounds"], 1)
    out["aggregate"] = {
        "off": agg["off"],
        "on": agg["on"],
        "mttr_improvement": (
            round(agg["off"]["mttr_rounds"] - agg["on"]["mttr_rounds"], 3)
            if agg["off"]["mttr_rounds"] is not None
            and agg["on"]["mttr_rounds"] is not None
            else None
        ),
        "commit_stall_improvement": (
            agg["off"]["commit_stall_group_rounds"]
            - agg["on"]["commit_stall_group_rounds"]
        ),
    }
    # The headline gates: the closed loop must MEASURABLY heal, never
    # merely not-hurt — a vacuous corpus (no episodes, no actions) fails
    # loudly instead of passing silently.
    if total_actions == 0:
        failed.append(
            "the autopilot took zero actions across the whole corpus; "
            "the self-healing claim is vacuous (policy/threshold rot?)"
        )
    off_m, on_m = agg["off"]["mttr_rounds"], agg["on"]["mttr_rounds"]
    if off_m is None or on_m is None:
        failed.append(
            "no leaderless episodes healed in one of the configurations; "
            "the MTTR comparison cannot run (corpus rot?)"
        )
    elif on_m >= off_m:
        failed.append(
            f"aggregate MTTR with autopilot on ({on_m}) failed to beat "
            f"the autopilot-off replay ({off_m})"
        )
    if (
        agg["on"]["commit_stall_group_rounds"]
        > agg["off"]["commit_stall_group_rounds"]
    ):
        failed.append(
            "aggregate commit-stall group-rounds worsened with the "
            f"autopilot on ({agg['on']['commit_stall_group_rounds']} vs "
            f"{agg['off']['commit_stall_group_rounds']})"
        )
    if to_capture:
        from ..multiraft import forensics

        art_dir = args.artifacts_dir or os.path.dirname(
            os.path.abspath(args.out)
        )
        forensics.report_failures(
            to_capture, out,
            lambda name, doc, on_side: capture_incident(
                doc, args.groups, args.cadence, on_side, art_dir, name,
                device=dev,
            ),
        )
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    if failed:
        for msg in failed:
            print(f"ERROR: {msg}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
