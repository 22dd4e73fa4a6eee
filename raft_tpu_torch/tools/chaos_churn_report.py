"""Before/after election-damping churn report over the chaos golden corpus,
counterpart of `tools/chaos_churn_report.py` on the port.

Runs every scenario in tests/testdata/chaos/plans.json twice — undamped
and fully damped (SimConfig check_quorum + pre_vote) — through the chaos
runner (ClusterSim.run_plan) and writes one JSON document comparing the
runs per plan:

    {"groups": 128, "plans": {
        "asymmetric-link": {
            "undamped": {"mttr_rounds": ..., "reelections": ...,
                         "max_term": ..., "peak_term_bumps": ...,
                         "vote_splits": ..., "safety": {...}},
            "damped":   {...},
            "term_growth_ratio": 0.12}, ...}}

`max_term` is the fleet max term at scenario end (every run starts from a
fresh term-0 boot, so it IS the cumulative term growth), and
`peak_term_bumps` / `vote_splits` are end-of-run maxima over groups of the
health planes.  Any safety-invariant count in EITHER configuration exits
2, and so does a damped run whose term growth fails to undercut the
undamped run on the asymmetric-link scenario.

With `--fused` each scenario's damped half also replays through the fused
damped dispatcher (fused_step.fast_multi_round(k=1): fused steady rounds
and general chaos rounds both covered), and the run exits 2 if any churn
stat diverges from the runner's damped run.

On a nonzero safety count the offending scenario re-runs with the black box
on (a pure observer) and the incident JSON plus the generated one-group
datadriven repro are written next to the report
(forensics.capture_chaos_incident, through forensics.report_failures).

Usage:  python -m raft_tpu_torch.tools.chaos_churn_report [--groups N]
        [--fused] [--out FILE] [--artifacts-dir DIR] [--device cpu]

Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PLANS = os.path.join(REPO, "tests", "testdata", "chaos", "plans.json")

# (groups, n_peers) -> (SimConfig, fused dispatcher), shared across the
# corpus.
_FUSED_CACHE: dict = {}


def run_config(doc: dict, groups: int, damped: bool, device=None) -> dict:
    from ..multiraft import ClusterSim, SimConfig, chaos, kernels

    plan = chaos.plan_from_dict(doc)
    cfg = SimConfig(
        n_groups=groups,
        n_peers=plan.n_peers,
        collect_health=True,
        check_quorum=damped,
        pre_vote=damped,
    )
    sim = ClusterSim(cfg, chaos=plan, device=device)
    report = sim.run_plan()
    planes = sim._health.planes.cpu().numpy()
    term = sim.state.term.cpu().numpy()
    return {
        "mttr_rounds": report["mttr_rounds"],
        "reelections": report["reelections"],
        "max_leaderless_streak": report["max_leaderless_streak"],
        "max_term": int(term.max()),
        "peak_term_bumps": int(planes[kernels.HP_TERM_BUMPS].max()),
        "vote_splits": int(planes[kernels.HP_VOTE_SPLITS].max()),
        "safety": report["safety"],
    }


def run_config_fused(doc: dict, groups: int, device=None) -> dict:
    """Replay the damped configuration through the FUSED damped dispatcher:
    fully-healed rounds go through fused_step.fast_multi_round(k=1) — fused
    when the damped steady predicate holds, the general damped step
    otherwise, so BOTH branches get golden-corpus coverage — and chaos
    rounds run the same link-gated general step the runner uses.  The
    caller diffs the churn stats against the runner's damped run."""
    from ..multiraft import SimConfig, chaos, fused_step, kernels
    from ..multiraft import sim as sim_mod
    from ..multiraft.platform import resolve_device

    dev = resolve_device(device)
    plan = chaos.plan_from_dict(doc)
    key = (groups, plan.n_peers)
    if key not in _FUSED_CACHE:
        cfg = SimConfig(
            n_groups=groups,
            n_peers=plan.n_peers,
            collect_health=True,
            check_quorum=True,
            pre_vote=True,
        )
        _FUSED_CACHE[key] = (
            cfg, fused_step.fast_multi_round(cfg, k=1, with_health=True),
        )
    cfg, fast = _FUSED_CACHE[key]
    sched = chaos.HostSchedule(plan, groups)
    st = sim_mod.init_state(cfg, device=dev)
    h = sim_mod.init_health(cfg, dev)
    safety = np.zeros(kernels.N_SAFETY, np.int64)
    prev_commit = st.commit
    n_fused = n_dispatched = 0
    for r in range(plan.n_rounds):
        link, crashed, append = sched.masks(r)
        cj = torch.from_numpy(np.ascontiguousarray(crashed)).to(dev)
        aj = torch.from_numpy(np.asarray(append, np.int32)).to(dev)
        if bool(link.all()):
            # Fully-healed round: bit-identical to link=None, so it can
            # ride the (lossless-branch) fused dispatcher.
            n_dispatched += 1
            n_fused += bool(fused_step.steady_predicate(cfg, st, cj, horizon=1))
            st, h = fast(st, cj, aj, h)
        else:
            st, h = sim_mod.step(
                cfg, st, cj, aj,
                link=torch.from_numpy(np.ascontiguousarray(link)).to(dev),
                health=h,
            )
        safety += np.asarray(
            kernels.check_safety(
                st.state, st.term, st.commit, st.last_index, st.agree,
                prev_commit,
            ).tolist(), np.int64,
        )
        prev_commit = st.commit
    planes = h.planes.cpu().numpy()
    term = st.term.cpu().numpy()
    return {
        "max_term": int(term.max()),
        "peak_term_bumps": int(planes[kernels.HP_TERM_BUMPS].max()),
        "vote_splits": int(planes[kernels.HP_VOTE_SPLITS].max()),
        "fused_rounds": n_fused,
        "dispatched_rounds": n_dispatched,
        "rounds": plan.n_rounds,
        "safety": dict(
            zip(kernels.SAFETY_NAMES, (int(v) for v in safety))
        ),
    }


FUSED_COMPARE_KEYS = ("max_term", "peak_term_bumps", "vote_splits")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.chaos_churn_report",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--groups", type=int, default=128)
    ap.add_argument(
        "--fused",
        action="store_true",
        help="also run each scenario's damped half through the fused "
        "damped dispatcher (fused_step.fast_multi_round) and fail if "
        "any churn stat diverges from the runner's damped run",
    )
    ap.add_argument("--out", default="chaos-churn-report.json")
    ap.add_argument(
        "--artifacts-dir",
        default="",
        help="directory for on-failure forensics artifacts (incident "
        "JSON + generated repro scenario); default: the --out directory",
    )
    ap.add_argument("--plans", default=PLANS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..multiraft.platform import resolve_device

    dev = resolve_device(args.device)
    with open(args.plans, "r", encoding="utf-8") as f:
        docs = json.load(f)
    out = {"groups": args.groups, "plans": {}}
    failed = []
    to_capture: dict = {}
    total_fused = 0
    for doc in docs:
        name = doc["name"]
        undamped = run_config(doc, args.groups, damped=False, device=dev)
        damped = run_config(doc, args.groups, damped=True, device=dev)
        ratio = (
            damped["max_term"] / undamped["max_term"]
            if undamped["max_term"]
            else None
        )
        out["plans"][name] = {
            "undamped": undamped,
            "damped": damped,
            "term_growth_ratio": round(ratio, 3) if ratio is not None else None,
        }
        checked = (("undamped", undamped), ("damped", damped))
        if args.fused:
            fused = run_config_fused(doc, args.groups, device=dev)
            out["plans"][name]["damped_fused"] = fused
            checked = checked + (("damped_fused", fused),)
            total_fused += fused["fused_rounds"]
            for key in FUSED_COMPARE_KEYS:
                if fused[key] != damped[key]:
                    failed.append(
                        f"{name}: fused-damped {key} {fused[key]} != "
                        f"scan-damped {damped[key]} — fusion changed the "
                        "churn result"
                    )
        for tag, rep in checked:
            if any(rep["safety"].values()):
                failed.append(f"{name}/{tag}: safety {rep['safety']}")
                to_capture[name] = (doc, tag != "undamped")
        print(
            f"{name}: max_term {undamped['max_term']} -> "
            f"{damped['max_term']}, peak bumps "
            f"{undamped['peak_term_bumps']} -> {damped['peak_term_bumps']}"
        )
    if args.fused and total_fused == 0:
        failed.append(
            "no golden-corpus round engaged the fused damped branch; the "
            "both-branches coverage claim is vacuous (predicate rot?)"
        )
    # The headline claim: damping collapses the asymmetric-partition term
    # inflation.  The scenario MUST be in the corpus.
    asym = out["plans"].get("asymmetric-link")
    if asym is None:
        failed.append(
            "golden corpus has no 'asymmetric-link' scenario; the churn "
            "collapse gate cannot run (renamed plan?)"
        )
    elif asym["damped"]["max_term"] >= asym["undamped"]["max_term"]:
        failed.append(
            "asymmetric-link: damped term growth "
            f"{asym['damped']['max_term']} did not undercut undamped "
            f"{asym['undamped']['max_term']}"
        )
    if to_capture:
        from ..multiraft import forensics

        art_dir = args.artifacts_dir or (
            os.path.dirname(os.path.abspath(args.out))
        )
        forensics.report_failures(
            to_capture, out,
            lambda name, doc, damped: forensics.capture_chaos_incident(
                doc, args.groups, art_dir, damped=damped,
                stem=f"incident-{name}", device=dev,
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
