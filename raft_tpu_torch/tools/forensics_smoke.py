"""Deliberately-trapped forensics smoke, counterpart of
`tools/forensics_smoke.py` on the port.

The golden corpora stay safety-zero, so the report tools' on-failure
artifact path would never execute in a healthy build — this run proves it
fires.  It injects both traps with the black box on (the clock-pause
stale-read trap and the stale-commit-propagation trap), drives the whole
trap-to-testcase pipeline, and exits 2 unless, for each trap:

  * the device capture names EXACTLY the injected offender groups;
  * the incident JSON and the generated datadriven repro scenario were
    written;
  * the repro replays RED on the one-group scalar oracle;
  * the same scenario replays GREEN with its trap directives disabled.

Then it drives the report tools' on-failure tail itself
(`forensics.report_failures`):

  * `forensics.capture_artifacts` off the commit-regress session's black
    box with the trap's fault column as a chaos plan: the incident names
    the first offender in the commit_regressed slot (the repro replays the
    fault column alone, without the injected surgery, so it does not
    reproduce, and is recorded as device-only);
  * `forensics.capture_chaos_incident` on a safety-zero golden chaos plan:
    the black-box re-run captures no offender, and report_failures records
    the capture's error instead of raising.

Usage:  python -m raft_tpu_torch.tools.forensics_smoke [--out-dir DIR]
        [--groups N] [--device cpu]

Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..multiraft.forensics import TrapSession

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PLANS = os.path.join(REPO, "tests", "testdata", "chaos", "plans.json")
HEALTHY_PLAN = "heal-all"  # a safety-zero scenario of the golden corpus
SETTLE_ROUNDS = 20  # run_commit_regress_trap's default settle


def check_trap(name: str, session: "TrapSession", offenders: list,
               slot: str, out_dir: str, errors: list) -> dict:
    from ..multiraft import forensics

    cap = session.sim.forensics()
    got = sorted(o["group"] for o in cap["offenders"][slot])
    if got != sorted(offenders):
        errors.append(
            f"{name}: captured groups {got} != injected "
            f"{sorted(offenders)}"
        )
    out = session.extract(out_dir, stem=name)
    for path_key in ("incident_path", "scenario_path"):
        if not os.path.exists(out[path_key]):
            errors.append(f"{name}: missing artifact {out[path_key]}")
    if not out["reproduced"]:
        errors.append(
            f"{name}: generated repro did NOT reproduce {out['slot']} "
            f"on the scalar oracle ({out['fired']})"
        )
    green = forensics.replay_scenario(
        out["scenario_path"], disable_traps=True
    )
    if any(green["fired"].values()):
        errors.append(
            f"{name}: repro still fires with traps disabled "
            f"({green['fired']}) — the scenario is not isolating the "
            "injected trap"
        )
    print(
        f"{name}: slot={out['slot']} group={out['group']} "
        f"round={out['round']} reproduced={out['reproduced']} "
        f"green_without_trap={not any(green['fired'].values())}"
    )
    return {
        "slot": out["slot"],
        "group": out["group"],
        "round": out["round"],
        "reproduced": out["reproduced"],
        "incident": out["incident_path"],
        "scenario": out["scenario_path"],
    }


def check_report_tail(session: "TrapSession", offenders: list, groups: int,
                      out_dir: str, device, errors: list) -> dict:
    """The report tools' on-failure tail: report_failures over a capture
    off the trapped session (capture_artifacts) and a black-box re-run of a
    safety-zero golden plan (capture_chaos_incident)."""
    from ..multiraft import forensics

    with open(PLANS, "r", encoding="utf-8") as f:
        healthy = next(d for d in json.load(f) if d["name"] == HEALTHY_PLAN)
    trap_faults = {
        "name": "commit-regress-faults",
        "peers": session.cfg.n_peers,
        "phases": [{"rounds": SETTLE_ROUNDS + 1, "append": 1}],
    }
    captures = {
        "commit_regress": ("trap", trap_faults),
        HEALTHY_PLAN: ("plan", healthy),
    }

    def capture(name, kind, doc):
        if kind == "trap":
            return forensics.capture_artifacts(
                session.sim, doc, out_dir, stem=f"tail-{name}"
            )
        return forensics.capture_chaos_incident(
            doc, groups, out_dir, stem=f"tail-{name}", device=device
        )

    out: dict = {}
    forensics.report_failures(captures, out, capture)
    got = out["forensics"]
    trapped = got["commit_regress"]
    if "error" in trapped:
        errors.append(f"report tail: capture_artifacts failed: {trapped['error']}")
    else:
        if (trapped["slot"], trapped["group"]) != ("commit_regressed", min(offenders)):
            errors.append(
                f"report tail: capture_artifacts named {trapped['slot']} "
                f"group {trapped['group']}, not commit_regressed group "
                f"{min(offenders)}"
            )
        if trapped["reproduced"]:
            errors.append(
                "report tail: the fault column alone reproduced the injected "
                "commit regression"
            )
        for path_key in ("incident_path", "scenario_path"):
            if not os.path.exists(trapped[path_key]):
                errors.append(f"report tail: missing artifact {trapped[path_key]}")
    if "no captured offenders" not in got[HEALTHY_PLAN].get("error", ""):
        errors.append(
            f"report tail: the safety-zero plan {HEALTHY_PLAN} captured "
            f"{got[HEALTHY_PLAN]}"
        )
    print(f"report tail: {json.dumps(got)}")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.forensics_smoke",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--out-dir", default="forensics-smoke")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..multiraft import forensics
    from ..multiraft.platform import resolve_device

    dev = resolve_device(args.device)
    errors: list = []
    summary = {}
    offenders = [g for g in range(args.groups) if g % 3 == 1]
    s1 = forensics.run_commit_regress_trap(
        n_groups=args.groups, offenders=offenders,
        settle_rounds=SETTLE_ROUNDS, device=dev,
    )
    summary["commit_regress"] = check_trap(
        "commit_regress", s1, offenders, "commit_regressed",
        args.out_dir, errors,
    )
    s2 = forensics.run_clock_pause_trap(n_groups=2, offenders=[1], device=dev)
    summary["clock_pause"] = check_trap(
        "clock_pause", s2, [1], "stale_read", args.out_dir, errors,
    )
    summary["report_tail"] = check_report_tail(
        s1, offenders, args.groups, args.out_dir, dev, errors,
    )
    with open(
        os.path.join(args.out_dir, "smoke-summary.json"), "w",
        encoding="utf-8",
    ) as f:
        json.dump(summary, f, indent=1)
    if errors:
        for msg in errors:
            print(f"ERROR: {msg}", file=sys.stderr)
        return 2
    print("forensics smoke: both traps captured, reproduced, and "
          "isolated; the report tail captured the trap and no false "
          "incident")
    return 0


if __name__ == "__main__":
    sys.exit(main())
