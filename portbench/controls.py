"""The check's control and its planted faults: systems that stand in for
the program and must come out not correct.

    control     the plain reference in the program's place, with
                replication elided (check.control_step), and its
                conf-change arm around it in traffic with conf changes:
                a leader commits what its followers never stored, which
                breaks the configurations' first guarantee;
    unchanged   the program's dispatcher returning each block's input
                state unchanged (and counting it fused);
    half        the program's block applied to the first half of the
                groups only, the rest left as they were;
    altered     the program's block with one group's commit changed by
                one where the block produces it.

The last three wrap the configuration's own system.  Four more plant a
fault in the reference's conf-change arm (reference/confchange.py), put
in the program's place; they differ from the reference only in traffic
with conf changes:

    swap_early      a step's masks swap one round early: at the start of
                    the round that proposes its entry;
    incoming_gate   the commit gate asks the incoming voters' majority
                    alone, on the owner's tracker row, and not its commit;
    uncommitted     a step applies once its owner still leads, committed
                    or not;
    learner_quorum  a learner counts toward a majority: in the gate and in
                    the commit picked up at apply, learners hold entries
                    toward the voters' majority.

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
from .reference import confchange as C
from .reference import raft_step as R

Program = spec.module(spec.PACKAGE, "systems", "fast_multi_round").Program


class Control:
    """The reference, replication elided, behind the program's interface.
    Its state carries the conf-change fields; in traffic with conf changes
    (the harness passes `confchanges`) its block runs `arm` around the
    round."""

    fused_kernel = ""

    def __init__(self, conf: dict, device):
        self.rc = check.ref_config(conf)
        self.conf = conf
        self.k = conf["block_rounds"]
        self.device = device
        self.arm = C.Arm(step=check.control_step)

    def prepare(self) -> None:
        pass

    def init_state(self):
        return check.full(check.init_state(self.rc, self.conf, self.device),
                          C.init_state(self.rc.n_peers, self.rc.n_groups, self.device))

    def step(self, st, crashed, append):
        return check.full(self.arm.step(self.rc, check.as_ref(st), crashed, append), C.of(st))

    def steady(self, st, crashed) -> bool:
        return check.settled(st, crashed)

    def block(self, st, crashed, append, fused: int, **cc):
        if "confchanges" in cc:
            return check.run_arm(self.rc, st, crashed, append, self.k, cc["confchanges"],
                                 self.arm), fused
        ref = check.run_reference(self.rc, st, crashed, append, self.k, self.arm.step)
        return check.full(ref, C.of(st)), fused


class SwapEarlyArm(C.Arm):
    def round(self, rc, st, cc, crashed, append):
        due = (cc.cc_step < cc.cc_len) & (cc.cc_stage == 0)
        return super().round(rc, self.apply(st, cc, due), cc, crashed, append)


def owner_row(matched, owner):
    """int32[P, G]: the owner's tracker row, matched[owner - 1, :, g]."""
    i = torch.clamp(owner - 1, 0, matched.shape[0] - 1).to(torch.int64)
    return matched.gather(0, i[None, None, :].expand(1, *matched.shape[1:]))[0]


class IncomingGateArm(C.Arm):
    def gate(self, st2, cc, crashed):
        _, retry = super().gate(st2, cc, crashed)
        row = owner_row(st2.matched, cc.cc_owner)
        held = ((row >= cc.cc_index[None, :]) & st2.voter_mask).sum(0)
        lead = (cc.cc_stage == 1) & ~retry
        return lead & (held >= R.majority_of(st2.voter_mask.sum(0))), retry


class UncommittedArm(C.Arm):
    def gate(self, st2, cc, crashed):
        apply, retry = super().gate(st2, cc, crashed)
        return (cc.cc_stage == 1) & ~retry, retry


class LearnerQuorumArm(C.Arm):
    @staticmethod
    def _pick(rows, counted, voters):
        """Per owner, the highest index that `counted` peers hold as often
        as the voters' majority: the learners count toward it."""
        vals = torch.where(counted.t()[None], rows, 0)
        srt = torch.sort(vals, dim=-1, descending=True).values
        need = R.majority_of(voters.sum(0))  # [G]
        i = torch.clamp(need - 1, 0, rows.shape[-1] - 1).to(torch.int64)
        return srt.gather(-1, i[None, :, None].expand(rows.shape[0], -1, 1))[..., 0]

    def gate(self, st2, cc, crashed):
        _, retry = super().gate(st2, cc, crashed)
        row = owner_row(st2.matched, cc.cc_owner)
        counted = st2.voter_mask | st2.learner_mask
        held = ((row >= cc.cc_index[None, :]) & counted).sum(0)
        lead = (cc.cc_stage == 1) & ~retry
        return lead & (held >= R.majority_of(st2.voter_mask.sum(0))), retry

    def apply(self, st2, cc, apply):
        out = super().apply(st2, cc, apply)
        rows = out.matched.transpose(1, 2)  # [owner, G, peer]
        mci = self._pick(rows, out.voter_mask | out.learner_mask, out.voter_mask)
        pickup = (apply[None, :] & (out.state == R.ROLE_LEADER)
                  & (mci >= out.term_start_index))
        return out._replace(commit=torch.where(pickup, torch.maximum(out.commit, mci),
                                               out.commit))


def arm_fault(arm_class):
    """The reference in the program's place, with a fault planted in its
    conf-change arm."""

    class ArmFault(Control):
        def __init__(self, conf: dict, device):
            super().__init__(conf, device)
            self.arm = arm_class()

    ArmFault.__name__ = arm_class.__name__
    return ArmFault


def _system(conf: dict):
    return spec.module(spec.PACKAGE, "systems", conf["system"]).Program


def unchanged(conf: dict, device):
    class Unchanged(_system(conf)):
        def block(self, st, crashed, append, fused: int, **cc):
            return st, fused + self.k * conf["n_groups"]

    return Unchanged(conf, device)


def half(conf: dict, device):
    class Half(_system(conf)):
        def block(self, st, crashed, append, fused: int, **cc):
            out, fused = super().block(st, crashed, append, fused, **cc)
            h = conf["n_groups"] // 2

            def keep(new, old):
                if new is None:
                    return None
                return torch.cat([new[..., :h], old[..., h:]], dim=-1)

            return type(out)(*map(keep, out, st)), fused

    return Half(conf, device)


def altered(conf: dict, device):
    class Altered(_system(conf)):
        def block(self, st, crashed, append, fused: int, **cc):
            out, fused = super().block(st, crashed, append, fused, **cc)
            commit = out.commit.clone()
            commit[0, conf["n_groups"] // 3] += 1
            return out._replace(commit=commit), fused

    return Altered(conf, device)


SYSTEMS = {"control": Control, "unchanged": unchanged, "half": half, "altered": altered,
           "swap_early": arm_fault(SwapEarlyArm),
           "incoming_gate": arm_fault(IncomingGateArm),
           "uncommitted": arm_fault(UncommittedArm),
           "learner_quorum": arm_fault(LearnerQuorumArm)}


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
