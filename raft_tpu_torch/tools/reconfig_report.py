"""Golden-corpus reconfig replay report, counterpart of
`tools/reconfig_report.py` on the port.

Runs every scenario in tests/testdata/reconfig/plans.json — a ReconfigPlan
riding the ChaosPlan the corpus pairs it with (membership churn DURING
partition/link-loss/crash) — through the reconfig+chaos runner
(ClusterSim.run_reconfig) and writes one JSON document summarizing each
run:

    {"groups": 128, "plans": {
        "joint_entry_split": {
            "undamped": {"proposals": ..., "ops_applied": ...,
                         "retries": ..., "joint_group_rounds": ...,
                         "mttr_rounds": ..., "reelections": ...,
                         "reconfig_stalled_groups": ..., "safety": {...}},
            "damped":   {...}},  ...}}

Both halves replay the identical schedule; `damped` turns on the full
election-damping configuration (SimConfig check_quorum + pre_vote).

The run fails (exit 2) if ANY safety-invariant count in EITHER
configuration is non-zero on ANY scenario, or if the `joint_exit_blocked`
scenario does NOT report reconfig-stalled groups in the undamped half
(that scenario downs the outgoing majority so the group sits in joint past
the stall threshold).  On a nonzero safety count the scenario re-runs with
the black box on and the incident JSON plus the generated repro are
written (forensics.capture_artifacts, through forensics.report_failures).

Usage:  python -m raft_tpu_torch.tools.reconfig_report [--groups N]
        [--out FILE] [--artifacts-dir DIR] [--device cpu]

Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, "tests", "testdata", "reconfig", "plans.json")

_KEEP = (
    "proposals", "ops_applied", "retries", "joint_group_rounds",
    "mttr_rounds", "reelections", "max_leaderless_streak",
    "reconfig_stalled_groups", "safety",
)


def run_scenario(doc: dict, groups: int, damped: bool,
                 blackbox: bool = False, device=None) -> "dict | tuple":
    from ..multiraft import ClusterSim, SimConfig, chaos, reconfig
    from ..multiraft.platform import resolve_device

    dev = resolve_device(device)
    plan = reconfig.plan_from_dict(doc["reconfig"])
    cplan = chaos.plan_from_dict(doc["chaos"])
    cfg = SimConfig(
        n_groups=groups,
        n_peers=plan.n_peers,
        collect_health=True,
        check_quorum=damped,
        pre_vote=damped,
        blackbox=blackbox,
    )
    sim = ClusterSim(cfg, *reconfig.initial_masks(plan, groups, dev), device=dev)
    report = sim.run_reconfig(plan, cplan)
    kept = {k: report[k] for k in _KEEP}
    if blackbox:
        return kept, sim, cplan
    return kept


def capture_incident(doc: dict, groups: int, damped: bool,
                     art_dir: str, name: str, device=None) -> dict:
    """The on-failure hook: re-run the failing scenario with the black box
    on (a pure observer) and write the incident JSON + generated repro.
    The repro replays the chaos fault column; the composed reconfig ops are
    in the incident JSON's windows."""
    from ..multiraft import forensics

    _, sim, cplan = run_scenario(doc, groups, damped, blackbox=True,
                                 device=device)
    return forensics.capture_artifacts(
        sim, cplan, art_dir, stem=f"incident-{name}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.reconfig_report",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--groups", type=int, default=128)
    ap.add_argument("--out", default="", metavar="FILE")
    ap.add_argument(
        "--artifacts-dir",
        default="",
        help="directory for on-failure forensics artifacts (incident "
        "JSON + generated repro); default: the --out directory (or cwd)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..multiraft.platform import resolve_device

    dev = resolve_device(args.device)
    with open(CORPUS, "r", encoding="utf-8") as f:
        corpus = json.load(f)

    out = {"groups": args.groups, "plans": {}}
    failures = []
    to_capture = {}
    for doc in corpus:
        name = doc["name"]
        entry = {}
        for label, damped in (("undamped", False), ("damped", True)):
            rep = run_scenario(doc, args.groups, damped, device=dev)
            entry[label] = rep
            if any(rep["safety"].values()):
                failures.append(
                    f"{name} [{label}]: safety violations {rep['safety']}"
                )
                to_capture[name] = (doc, damped)
        if (
            name == "joint_exit_blocked"
            and entry["undamped"]["reconfig_stalled_groups"] == 0
        ):
            failures.append(
                "joint_exit_blocked [undamped]: expected reconfig-stalled "
                "groups (downed outgoing majority pins the joint window) "
                "but the stall detection reported none"
            )
        out["plans"][name] = entry
        print(f"{name}: "
              + ", ".join(
                  f"{label} applied={rep['ops_applied']} "
                  f"retries={rep['retries']} "
                  f"stalled={rep['reconfig_stalled_groups']}"
                  for label, rep in entry.items()
              ),
              file=sys.stderr)

    if to_capture:
        from ..multiraft import forensics

        art_dir = args.artifacts_dir or (
            os.path.dirname(os.path.abspath(args.out)) if args.out
            else "."
        )
        forensics.report_failures(
            to_capture, out,
            lambda name, doc, damped: capture_incident(
                doc, args.groups, damped, art_dir, name, device=dev
            ),
        )

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2)

    if failures:
        for msg in failures:
            print(f"ERROR: {msg}", file=sys.stderr)
        return 2
    print(f"reconfig report: {len(out['plans'])} scenarios, "
          "all safety invariants zero", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
