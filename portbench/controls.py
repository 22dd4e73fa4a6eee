"""The check's control and its planted faults: systems that stand in for
the program and must come out not correct.

    control     the plain reference in the program's place, with
                replication elided (check.control_step): a leader commits
                what its followers never stored, which breaks the
                configurations' first guarantee;
    unchanged   the program's dispatcher returning each block's input
                state unchanged (and counting it fused);
    half        the program's block applied to the first half of the
                groups only, the rest left as they were;
    altered     the program's block with one group's commit changed by
                one where the block produces it.

    python3 -m portbench.controls --workload <cell> --system <name> \\
        --seeds <a,b,c> --seconds <s>

runs the cell once a seed with that system at the cell's own size and
prints, a seed a line, `correct` and every number the check compared.
The benchmark's own runs never run these; the tests under tests/ run
them on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, harness, spec
from .reference import raft_step as R

Program = spec.module(spec.PACKAGE, "systems", "fast_multi_round").Program


class Control:
    """The reference, replication elided, behind the program's interface."""

    fused_kernel = ""

    def __init__(self, conf: dict, device):
        self.rc = check.ref_config(conf)
        self.k = conf["block_rounds"]
        self.device = device

    def prepare(self) -> None:
        pass

    def init_state(self):
        return R.init_state(self.rc, self.device)

    def step(self, st, crashed, append):
        return check.control_step(self.rc, check.as_ref(st), crashed, append)

    def steady(self, st, crashed) -> bool:
        return check.settled(st, crashed)

    def block(self, st, crashed, append, fused: int):
        return check.run_reference(self.rc, st, crashed, append, self.k,
                                   control=True), fused


class Unchanged(Program):
    def block(self, st, crashed, append, fused: int):
        return st, fused + self.k * self.cfg.n_groups


class Half(Program):
    def block(self, st, crashed, append, fused: int):
        out, fused = super().block(st, crashed, append, fused)
        h = self.cfg.n_groups // 2

        def keep(new, old):
            if new is None:
                return None
            return torch.cat([new[..., :h], old[..., h:]], dim=-1)

        return type(out)(*map(keep, out, st)), fused


class Altered(Program):
    def block(self, st, crashed, append, fused: int):
        out, fused = super().block(st, crashed, append, fused)
        commit = out.commit.clone()
        commit[0, self.cfg.n_groups // 3] += 1
        return out._replace(commit=commit), fused


SYSTEMS = {"control": Control, "unchanged": Unchanged, "half": Half, "altered": Altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", choices=sorted(SYSTEMS), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             t0=time.perf_counter(), system=SYSTEMS[args.system])
        print(json.dumps({"workload": args.workload, "system": args.system, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
