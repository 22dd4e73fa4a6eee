"""Black-box forensics: from a safety count at fleet scale to a one-group
scalar repro.

Counterpart of `raft_tpu/multiraft/forensics.py` (all of it), on the
port's device black box and its own scalar core copy.

At 100k groups a nonzero `int32[kernels.N_SAFETY]` safety count says *that*
an invariant tripped, not which group, which round or why.  This module is
the host half of the drill-down:

  * the device half (SimConfig(blackbox=True)) carries sim.BlackboxState,
    a [W, G] ring of packed per-group round records plus the [N_SAFETY, G]
    first-trip plane, folded every round (kernels.blackbox_fold,
    kernels.check_safety_groups) and reduced to a fixed-size capture at
    the drain (kernels.blackbox_capture);
  * `build_incident` turns that capture into the self-contained incident
    JSON (schema `multiraft-incident-v1`): per-slot offender lists plus
    each offender group's decoded ring window;
  * `extract_repro` turns a captured offender into a datadriven scenario
    (the tests/testdata format): the group's bootstrap config and its
    per-round schedule column (faults, appends, reads and any injected
    trap directives), replayed through a one-group simref.ScalarCluster on
    the group's own timeout stream (`timeout_seed_base=`, so the scalar
    run is the twin of the device run) with a host-side audit of the
    violated slots, the observed outcome recorded as the expected output.
    A trap scenario replays RED and turns green with its trap directives
    disabled; an organic device-only divergence records `reproduced=no`.

The injected traps are the negative tests of the whole safety net:
`run_clock_pause_trap` (a deposed-but-unaware leader with a frozen clock
serving lease reads across a partition) and `run_commit_regress_trap` (a
stale broadcast knocking a commit cursor backwards).  Each must capture
exactly its injected offenders.

The scalar audit covers dual_leader, commit_regressed, stale_read and
dual_lease, the slots observable on a scalar snapshot without the device's
pairwise agree/matched planes; the other slots still capture offenders on
the device, and their repros record `reproduced=no`.

Where the reference jits the trap session's round, here it is a plain call
of sim.step on the session's device (`cuda` unless the caller asks for the
CPU).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .platform import DeviceLike

SCHEMA = "multiraft-incident-v1"

# Slots the one-group scalar replay can audit (module docstring).
SCALAR_SLOTS = ("dual_leader", "commit_regressed", "stale_read",
                "dual_lease")


# --- per-group round records (the repro's schedule column) ----------------


@dataclass
class RoundRecord:
    """One group's directives for one protocol round of a repro scenario.

    crashed: per-peer isolation row (length P).
    link:    P x P directed reachability (None = all up).
    append:  entries proposed at the acting leader this round.
    read:    sim.READ_* code (0 none, 1 safe, 2 lease).
    freeze:  trap — 1-based peer whose election clock is pinned to 0
             while it leads (the clock-pause stale-read trap); 0 = none.
    regress: trap — (1-based peer, delta): the peer's commit cursor is
             knocked back `delta` entries AFTER the round's pump (the
             stale-commit-propagation trap); None = no surgery.
    """

    crashed: List[bool] = field(default_factory=list)
    link: Optional[List[List[bool]]] = None
    append: int = 0
    read: int = 0
    freeze: int = 0
    regress: Optional[Tuple[int, int]] = None

    def is_default(self, n_peers: int) -> bool:
        return (
            not any(self.crashed)
            and self.link is None
            and self.append == 0
            and self.read == 0
            and self.freeze == 0
            and self.regress is None
        )


class SessionLog:
    """Host-side record of the full-fleet planes a black-box session was
    driven with, one entry per round — what extract_repro slices a
    single group's column out of.  The compiled-plan paths rebuild the
    same information from chaos.HostSchedule instead (schedule_records).
    """

    def __init__(self, n_peers: int, n_groups: int):
        self.n_peers = n_peers
        self.n_groups = n_groups
        self.rounds: List[dict] = []

    def record(self, crashed=None, link=None, append_n=None,
               read_modes=None, freeze=None, regress=None) -> None:
        """Append one round: crashed bool[P, G], link bool[P, P, G],
        append int[G], read_modes int[G], freeze int[G] (1-based peer
        whose clock was pinned, 0 none), regress {g: (peer, delta)}."""
        self.rounds.append({
            "crashed": None if crashed is None else np.asarray(crashed),
            "link": None if link is None else np.asarray(link),
            "append": None if append_n is None else np.asarray(append_n),
            "read": None if read_modes is None else np.asarray(read_modes),
            "freeze": None if freeze is None else np.asarray(freeze),
            "regress": dict(regress) if regress else {},
        })

    def slice_group(self, g: int) -> List[RoundRecord]:
        P = self.n_peers
        out: List[RoundRecord] = []
        for rd in self.rounds:
            link = rd["link"]
            if link is not None:
                col = link[:, :, g]
                link_rec = (
                    None if bool(col.all()) else
                    [[bool(v) for v in row] for row in col]
                )
            else:
                link_rec = None
            out.append(RoundRecord(
                crashed=(
                    [False] * P if rd["crashed"] is None
                    else [bool(v) for v in rd["crashed"][:, g]]
                ),
                link=link_rec,
                append=(
                    0 if rd["append"] is None else int(rd["append"][g])
                ),
                read=0 if rd["read"] is None else int(rd["read"][g]),
                freeze=(
                    0 if rd["freeze"] is None else int(rd["freeze"][g])
                ),
                regress=rd["regress"].get(g),
            ))
        return out


def schedule_records(sched, g: int) -> List[RoundRecord]:
    """One group's RoundRecord column out of a compiled chaos schedule's
    host twin (chaos.HostSchedule) — the organic-failure repro path: the
    effective per-round masks (base link minus the seeded loss draw,
    crash row, append) exactly as the device scan saw them."""
    P = sched.n_peers
    out: List[RoundRecord] = []
    for r in range(sched.n_rounds):
        link, crashed, append = sched.masks(r)
        col = link[:, :, g]
        out.append(RoundRecord(
            crashed=[bool(v) for v in crashed[:, g]],
            link=(
                None if bool(col.all()) else
                [[bool(v) for v in row] for row in col]
            ),
            append=int(append[g]),
        ))
    return out


# --- incident JSON ---------------------------------------------------------


def decode_window(meta_col, term_col, commit_col, rounds_folded: int
                  ) -> List[dict]:
    """Decode one group's black-box ring columns ([W] arrays) into
    oldest-to-newest round records — the numpy twin of the device's
    pack_blackbox_meta layout."""
    W = len(meta_col)
    meta_col = np.asarray(meta_col, dtype=np.uint64)
    out: List[dict] = []
    for r in range(max(0, rounds_folded - W), rounds_folded):
        word = int(meta_col[r % W])
        bits = (word >> kernels.BB_SAFETY_SHIFT) & (
            (1 << kernels.N_SAFETY) - 1
        )
        out.append({
            "round": r,
            "role": word & 3,
            "leader": (word >> kernels.BB_LEADER_SHIFT) & 0xF,
            "term": int(term_col[r % W]),
            "commit": int(commit_col[r % W]),
            "fired": [
                kernels.SAFETY_NAMES[s]
                for s in range(kernels.N_SAFETY)
                if bits & (1 << s)
            ],
        })
    return out


def build_incident(sim) -> dict:
    """The full incident JSON off a black-box ClusterSim: the fixed-size
    capture (per-slot counts and first-K offenders) plus each offender
    group's decoded ring window.  Downloads the capture and O(W) ring
    values per distinct offender, never a [., G] plane."""
    cap = sim.forensics()
    bb = sim._require_blackbox()
    groups = sorted({
        o["group"]
        for offs in cap["offenders"].values()
        for o in offs
    })
    windows: Dict[str, List[dict]] = {}
    for g in groups:
        meta_c, term_c, commit_c = sim._group_column(
            g, [bb.meta, bb.term, bb.commit]
        ).reshape(3, -1).cpu().numpy()
        windows[str(g)] = decode_window(
            meta_c.view(np.uint32), term_c, commit_c, cap["rounds_folded"]
        )
    return {
        "schema": SCHEMA,
        "groups": sim.cfg.n_groups,
        "peers": sim.cfg.n_peers,
        "blackbox_window": sim.cfg.blackbox_window,
        "rounds_folded": cap["rounds_folded"],
        "counts": cap["counts"],
        "offenders": cap["offenders"],
        "windows": windows,
    }


# --- the datadriven scenario format ---------------------------------------


def _link_bits(link: Sequence[Sequence[bool]]) -> str:
    return "".join(
        "1" if v else "0" for row in link for v in row
    )


def _parse_link_bits(bits: str, n_peers: int) -> List[List[bool]]:
    if len(bits) != n_peers * n_peers:
        raise ValueError(
            f"link directive has {len(bits)} bits, expected "
            f"{n_peers * n_peers}"
        )
    it = iter(bits)
    return [
        [next(it) == "1" for _ in range(n_peers)]
        for _ in range(n_peers)
    ]


_READ_WORDS = {0: "", 1: "safe", 2: "lease"}
_READ_CODES = {"safe": 1, "lease": 2}


def render_rounds(records: List[RoundRecord], n_peers: int) -> str:
    """The scenario's input block: one `r<N> key=value...` line per
    non-default round (missing rounds replay as quiet all-up rounds)."""
    lines: List[str] = []
    for r, rec in enumerate(records):
        if rec.is_default(n_peers):
            continue
        parts = [f"r{r}"]
        if rec.append:
            parts.append(f"append={rec.append}")
        if any(rec.crashed):
            parts.append("crash=" + ",".join(
                str(p + 1) for p, c in enumerate(rec.crashed) if c
            ))
        if rec.link is not None:
            parts.append(f"link={_link_bits(rec.link)}")
        if rec.read:
            parts.append(f"read={_READ_WORDS[rec.read]}")
        if rec.freeze:
            parts.append(f"freeze={rec.freeze}")
        if rec.regress is not None:
            parts.append(f"regress={rec.regress[0]}:{rec.regress[1]}")
        lines.append(" ".join(parts))
    return "\n".join(lines)


def parse_rounds(text: str, n_peers: int) -> Dict[int, RoundRecord]:
    """Inverse of render_rounds."""
    out: Dict[int, RoundRecord] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if not parts[0].startswith("r"):
            raise ValueError(f"bad round line: {line!r}")
        r = int(parts[0][1:])
        rec = RoundRecord(crashed=[False] * n_peers)
        for part in parts[1:]:
            key, _, val = part.partition("=")
            if key == "append":
                rec.append = int(val)
            elif key == "crash":
                for p in val.split(","):
                    rec.crashed[int(p) - 1] = True
            elif key == "link":
                rec.link = _parse_link_bits(val, n_peers)
            elif key == "read":
                rec.read = _READ_CODES[val]
            elif key == "freeze":
                rec.freeze = int(val)
            elif key == "regress":
                peer, _, delta = val.partition(":")
                rec.regress = (int(peer), int(delta))
            else:
                raise ValueError(f"unknown directive {key!r} in {line!r}")
        out[r] = rec
    return out


def render_meta(meta: dict) -> str:
    """The scenario's directive line: `repro` + its key=value args."""
    keys = (
        "slot", "group", "peers", "rounds", "election_tick",
        "heartbeat_tick", "check_quorum", "pre_vote", "lease_read",
    )
    parts = ["repro"] + [f"{k}={meta[k]}" for k in keys]
    for mk in ("voters", "outgoing", "learners"):
        ids = meta.get(mk)
        if ids:
            parts.append(f"{mk}=({','.join(str(i) for i in ids)})")
    return " ".join(parts)


def meta_from_args(args: Dict[str, List[str]]) -> dict:
    """Inverse of render_meta, from {key: vals} directive arguments."""
    def one(k, default=None, cast=int):
        vals = args.get(k)
        if not vals:
            if default is None:
                raise ValueError(f"repro directive missing {k}=")
            return default
        return cast(vals[0])

    meta = {
        "slot": one("slot", cast=str),
        "group": one("group"),
        "peers": one("peers"),
        "rounds": one("rounds"),
        "election_tick": one("election_tick", 10),
        "heartbeat_tick": one("heartbeat_tick", 1),
        "check_quorum": one("check_quorum", 0),
        "pre_vote": one("pre_vote", 0),
        "lease_read": one("lease_read", 0),
    }
    for mk in ("voters", "outgoing", "learners"):
        vals = args.get(mk)
        meta[mk] = [int(v) for v in vals] if vals else []
    return meta


# --- the one-group scalar replay ------------------------------------------


def _scalar_lease_holders(cluster, election_tick: int) -> List[bool]:
    """Per-peer holder mask: the host twin of kernels.lease_read's
    hardened gate (and of simref.ReadOracle.lease_gate, evaluated at
    EVERY peer — the SV_DUAL_LEASE surface needs the full mask)."""
    from ..scalar.raft import StateRole

    out = []
    for p in range(1, cluster.n_peers + 1):
        r = cluster.networks[0].peers[p].raft
        active = {id for id, pr in r.prs.iter() if pr.recent_active}
        active.add(r.id)
        out.append(
            r.check_quorum
            and r.state == StateRole.Leader
            and r.leader_id == r.id
            and r.election_elapsed < election_tick
            and not r.lead_transferee
            and r.commit_to_current_term()
            and r.prs.has_quorum(active)
        )
    return out


def replay(meta: dict, rounds: Dict[int, RoundRecord],
           disable_traps: bool = False) -> dict:
    """Replay a repro scenario through a ONE-group simref.ScalarCluster
    on the offending group's global timeout stream, auditing the
    SCALAR_SLOTS each round; returns {"fired": {slot: count}, "rounds"}.

    The audit mirrors the device fold's timing: the lease slots
    (stale_read / dual_lease) evaluate on the round-ENTRY state — after
    any freeze surgery, before the ticks, exactly where
    kernels.lease_read's holder mask is taken — and the transition slots
    (dual_leader / commit_regressed) evaluate on the round-EXIT state
    against the entry commits, exactly check_safety's (st2, prev_commit)
    pair.  `disable_traps` skips the freeze/regress directives (and
    nothing else): a trap scenario must replay RED normally and green
    with the traps off — the generated-repro acceptance gate.
    """
    from ..scalar.raft import StateRole
    from .simref import ScalarCluster

    P = meta["peers"]
    cluster = ScalarCluster(
        1, P,
        election_tick=meta["election_tick"],
        heartbeat_tick=meta["heartbeat_tick"],
        voters=meta.get("voters") or None,
        voters_outgoing=meta.get("outgoing") or None,
        learners=meta.get("learners") or None,
        check_quorum=bool(meta["check_quorum"]),
        pre_vote=bool(meta["pre_vote"]),
        timeout_seed_base=meta["group"],
    )
    fired = {name: 0 for name in kernels.SAFETY_NAMES}
    lease_on = bool(meta["lease_read"]) and bool(meta["check_quorum"])
    prev_commit = [0] * P
    default = RoundRecord(crashed=[False] * P)
    for r in range(meta["rounds"]):
        rec = rounds.get(r, default)
        # Trap surgery, round entry (the device trap pins the recorded
        # leader's clock BEFORE each round's ticks).
        if rec.freeze and not disable_traps:
            raft = cluster.networks[0].peers[rec.freeze].raft
            if raft.state == StateRole.Leader:
                raft.election_elapsed = 0
        # Round-entry lease audit (serve-time state).
        if lease_on:
            holders = _scalar_lease_holders(
                cluster, meta["election_tick"]
            )
            commits = [
                cluster.networks[0].peers[p + 1].raft.raft_log.committed
                for p in range(P)
            ]
            if sum(holders) >= 2:
                fired["dual_lease"] += 1
            # Only a LEASE read arms the stale-read slot (the compiled
            # runner's lease_fire = pmode == READ_LEASE rule); a Safe
            # read runs the quorum round and is linearizable.
            if rec.read == 2:
                high = max(commits)
                if any(
                    h and c < high for h, c in zip(holders, commits)
                ):
                    fired["stale_read"] += 1
        crashed = np.asarray([rec.crashed], dtype=bool)
        append = np.asarray([rec.append], dtype=np.int64)
        link = None
        if rec.link is not None:
            link = np.asarray(rec.link, dtype=bool)[:, :, None]
        cluster.round(crashed, append, link)
        # Trap surgery, round exit (the stale-commit-propagation class:
        # a stale broadcast knocks the cursor back after the pump).
        if rec.regress is not None and not disable_traps:
            peer, delta = rec.regress
            log = cluster.networks[0].peers[peer].raft.raft_log
            log.committed = max(0, log.committed - delta)
        # Round-exit transition audit vs the entry commits.
        rafts = [
            cluster.networks[0].peers[p + 1].raft for p in range(P)
        ]
        commits = [rf.raft_log.committed for rf in rafts]
        if any(c < pc for c, pc in zip(commits, prev_commit)):
            fired["commit_regressed"] += 1
        lead_terms = [
            rf.term for rf in rafts if rf.state == StateRole.Leader
        ]
        if len(lead_terms) != len(set(lead_terms)):
            fired["dual_leader"] += 1
        prev_commit = commits
    return {"rounds": meta["rounds"], "fired": fired}


def render_outcome(meta: dict, result: dict) -> str:
    """The scenario's expected-output block: nonzero fired counts plus
    the target slot's verdict."""
    fired = result["fired"]
    nonzero = " ".join(
        f"{name}={fired[name]}"
        for name in kernels.SAFETY_NAMES
        if fired[name]
    )
    lines = [f"violations: {nonzero if nonzero else 'none'}"]
    if meta["slot"] not in SCALAR_SLOTS:
        # The replay audits only the scalar-observable slots (module
        # docstring): a pairwise-plane slot cannot fire here, and saying
        # NOT-REPRODUCED would misread as a failed repro.
        verdict = "DEVICE-ONLY (slot not scalar-auditable in v1)"
    elif fired.get(meta["slot"], 0):
        verdict = "REPRODUCED"
    else:
        verdict = "NOT-REPRODUCED"
    lines.append(f"target {meta['slot']}: {verdict}")
    return "\n".join(lines)


def scenario_text(meta: dict, records: List[RoundRecord],
                  outcome: str) -> str:
    """One committed-format datadriven case (scalar.datadriven): the
    repro directive, the round lines, and the replay outcome."""
    header = (
        f"# Generated by raft_tpu_torch.multiraft.forensics ({SCHEMA}).\n"
        f"# Replays global group {meta['group']} on timeout stream "
        f"{meta['group']} as a one-group scalar cluster; regenerate "
        f"with RAFT_TPU_REWRITE=1.\n"
    )
    body = render_rounds(records, meta["peers"])
    return (
        header + render_meta(meta) + "\n" + body + "\n----\n"
        + outcome + "\n"
    )


def replay_scenario(path_or_text: str, disable_traps: bool = False
                    ) -> dict:
    """Replay a generated scenario file (or its text) and return the
    replay result plus the recorded expectation: {"fired", "rounds",
    "meta", "outcome", "expected"}."""
    from ..scalar.datadriven import parse_file

    if os.path.exists(path_or_text):
        cases = parse_file(path_or_text)
    else:
        import tempfile

        fd, tmp = tempfile.mkstemp(suffix=".txt")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(path_or_text)
            cases = parse_file(tmp)
        finally:
            os.unlink(tmp)
    if len(cases) != 1 or cases[0].cmd != "repro":
        raise ValueError("expected exactly one `repro` case")
    td = cases[0]
    meta = meta_from_args({a.key: a.vals for a in td.cmd_args})
    rounds = parse_rounds(td.input, meta["peers"])
    result = replay(meta, rounds, disable_traps=disable_traps)
    result["meta"] = meta
    result["outcome"] = render_outcome(meta, result)
    result["expected"] = td.expected.strip()
    return result


# --- trap-to-testcase ------------------------------------------------------

# Severity order for picking the incident's headline slot: the
# linearizability and replication slots outrank bookkeeping ones.
_SLOT_PRIORITY = (
    "commit_diverged", "stale_read", "dual_lease", "dual_leader",
    "commit_regressed", "commit_no_quorum", "leader_not_in_config",
    "conf_double_change", "cursor_invalid",
)


def pick_offender(capture: dict, slot: Optional[str] = None
                  ) -> Tuple[str, int, int]:
    """(slot, group, trip_round) of the incident's headline offender:
    the requested slot's first capture, or the highest-priority fired
    slot's."""
    counts = capture["counts"]
    if slot is None:
        for name in _SLOT_PRIORITY:
            if counts.get(name, 0) > 0:
                slot = name
                break
    if slot is None or not counts.get(slot, 0):
        raise ValueError(f"no captured offenders (counts: {counts})")
    off = capture["offenders"][slot][0]
    return slot, off["group"], off["round"]


def extract_repro(sim, records_of_group, out_dir: str,
                  slot: Optional[str] = None, stem: str = "incident"
                  ) -> dict:
    """Trap-to-testcase, zero manual steps: pick the captured offender
    (pick_offender), write the incident JSON, slice the offending
    group's schedule column (`records_of_group(g) -> [RoundRecord]`),
    replay it through the one-group scalar cluster, and write the
    self-contained datadriven scenario with the observed outcome.

    Returns {"slot", "group", "round", "reproduced", "fired",
    "incident_path", "scenario_path"}.
    """
    os.makedirs(out_dir, exist_ok=True)
    capture = sim.forensics()
    slot, group, trip = pick_offender(capture, slot)
    incident = build_incident(sim)
    incident["headline"] = {
        "slot": slot, "group": group, "round": trip,
    }
    incident_path = os.path.join(out_dir, f"{stem}.json")
    with open(incident_path, "w", encoding="utf-8") as f:
        json.dump(incident, f, indent=1)
    records = records_of_group(group)
    # The scenario covers the window up to (and including) the trip
    # round; later rounds add nothing to the repro.
    records = records[: trip + 1]
    cfg = sim.cfg
    st = sim.state
    vm, om, lm = torch.stack([
        st.voter_mask[:, group], st.outgoing_mask[:, group],
        st.learner_mask[:, group],
    ]).cpu().numpy()
    meta = {
        "slot": slot,
        "group": group,
        "peers": cfg.n_peers,
        "rounds": len(records),
        "election_tick": cfg.election_tick,
        "heartbeat_tick": cfg.heartbeat_tick,
        "check_quorum": int(cfg.check_quorum),
        "pre_vote": int(cfg.pre_vote),
        "lease_read": int(cfg.lease_read),
        # Bootstrap config: the group's CURRENT masks (a mid-plan
        # capture of a reconfigured group replays its end-state
        # config); the uniform all-voters default is elided below.
        "voters": [p + 1 for p in range(cfg.n_peers) if vm[p]],
        "outgoing": [p + 1 for p in range(cfg.n_peers) if om[p]],
        "learners": [p + 1 for p in range(cfg.n_peers) if lm[p]],
    }
    if all(vm) and not any(om) and not any(lm):
        meta["voters"] = []  # the all-voters default; keep the file lean
    rounds = {r: rec for r, rec in enumerate(records)}
    result = replay(meta, rounds)
    outcome = render_outcome(meta, result)
    scenario_path = os.path.join(out_dir, f"{stem}_repro.txt")
    with open(scenario_path, "w", encoding="utf-8") as f:
        f.write(scenario_text(meta, records, outcome))
    return {
        "slot": slot,
        "group": group,
        "round": trip,
        "reproduced": bool(result["fired"].get(slot, 0)),
        "fired": result["fired"],
        "incident_path": incident_path,
        "scenario_path": scenario_path,
    }


# --- the injected trap sessions (the safety net's negative tests) ---------


class TrapSession:
    """Drive a black-box ClusterSim round by round with a full per-round
    safety audit and a host-side SessionLog: the ad-hoc stepping path the
    injected traps use (the runners fold the same audit in their loops).
    Each step: apply the trap surgery, take the round-entry lease mask,
    step the sim (the black box rides step(blackbox=)), audit the
    transition with kernels.check_safety_groups, and stamp the fired bits
    onto the round's ring record (ClusterSim.record_safety).  Runs on
    `cuda` unless `device` says otherwise."""

    def __init__(self, cfg, device: DeviceLike = None):
        from . import sim as sim_mod

        if not cfg.blackbox:
            raise ValueError("TrapSession needs SimConfig(blackbox=True)")
        self.cfg = cfg
        self.sim = sim_mod.ClusterSim(cfg, device=device)
        self.log = SessionLog(cfg.n_peers, cfg.n_groups)
        self._safety = torch.zeros(
            (kernels.N_SAFETY,), dtype=torch.int64, device=self.sim.device
        )

    @property
    def safety(self) -> np.ndarray:
        """int64[N_SAFETY] violation counts of every round so far."""
        return self._safety.cpu().numpy()

    def _on_device(self, x, dtype):
        return None if x is None else torch.as_tensor(x).to(
            device=self.sim.device, dtype=dtype
        )

    def step(self, crashed=None, append_n=None, link=None,
             read_modes=None, freeze_mask=None, regress=None) -> None:
        """One audited round.  crashed bool[P, G], append_n int[G], link
        bool[P, P, G] and read_modes int[G] (sim.READ_*) are numpy arrays
        or tensors; freeze_mask: bool[P, G] peers whose election clock is
        pinned to 0 while they lead (applied to the round-entry state);
        regress: {g: (1-based peer, delta)} commit knock-back applied to
        the round-exit state, before the audit."""
        from . import sim as sim_mod

        cfg = self.cfg
        G, P = cfg.n_groups, cfg.n_peers
        dev = self.sim.device
        sim = self.sim
        st = sim.state
        log_args = dict(crashed=crashed, link=link, append_n=append_n,
                        read_modes=read_modes)
        crashed = self._on_device(crashed, torch.bool)
        append_n = self._on_device(append_n, torch.int32)
        link = self._on_device(link, torch.bool)
        read_modes = self._on_device(read_modes, torch.int32)
        if crashed is None:
            crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
        if append_n is None:
            append_n = torch.zeros((G,), dtype=torch.int32, device=dev)
        if read_modes is None:
            read_modes = torch.zeros((G,), dtype=torch.int32, device=dev)
        freeze_row = None
        if freeze_mask is not None:
            fm = self._on_device(freeze_mask, torch.bool)
            st = st._replace(election_elapsed=torch.where(
                fm & (st.state == kernels.ROLE_LEADER), 0, st.election_elapsed
            ))
            # The logged directive: the (single) pinned peer per group.
            fm_h = np.asarray(
                freeze_mask.cpu() if torch.is_tensor(freeze_mask) else freeze_mask
            )
            freeze_row = (fm_h * (np.arange(P)[:, None] + 1)).max(axis=0)
        lease_args = {}
        if cfg.lease_read:
            holder, _, _ = kernels.lease_read(
                st.state, st.term, st.leader_id, st.election_elapsed,
                st.commit, st.term_start_index, crashed, cfg.election_tick,
                cfg.check_quorum and cfg.lease_read, st.transferee,
                st.recent_active, st.voter_mask, st.outgoing_mask,
            )
            # Only lease reads arm the stale-read slot (the runners' rule);
            # a Safe read is a quorum round and linearizable by construction.
            lease_args = {
                "lease_holder": holder,
                "lease_fire": read_modes == sim_mod.READ_LEASE,
            }
        st2, bb2, _receipt = sim_mod.step(
            cfg, st, crashed, append_n, link=link, read_propose=read_modes,
            blackbox=sim._blackbox,
        )
        if regress:
            peers = torch.tensor([p - 1 for p, _ in regress.values()], device=dev)
            groups = torch.tensor(list(regress), device=dev)
            deltas = torch.tensor(
                [d for _, d in regress.values()], dtype=torch.int32, device=dev
            )
            commit = st2.commit.clone()
            commit[peers, groups] = (commit[peers, groups] - deltas).clamp(min=0)
            st2 = st2._replace(commit=commit)
        viol = kernels.check_safety_groups(
            st2.state, st2.term, st2.commit, st2.last_index, st2.agree,
            st.commit, **lease_args,
        )
        sim.state = st2
        sim._blackbox = bb2
        sim.record_safety(viol)
        self._safety += viol.sum(1)
        self.log.record(freeze=freeze_row, regress=regress, **{
            k: None if v is None else (v.cpu() if torch.is_tensor(v) else v)
            for k, v in log_args.items()
        })

    def extract(self, out_dir: str, slot: Optional[str] = None,
                stem: str = "incident") -> dict:
        """extract_repro over this session's log."""
        return extract_repro(
            self.sim, self.log.slice_group, out_dir, slot=slot, stem=stem,
        )


def run_clock_pause_trap(n_groups: int = 2, n_peers: int = 3,
                         offenders: Optional[Sequence[int]] = None,
                         election_tick: int = 10,
                         settle_rounds: int = 30,
                         device: DeviceLike = None) -> TrapSession:
    """The stale-read trap, end to end with the black box on: settle,
    partition each offender group's leader away from the majority, pin the
    cut-off leader's election clock (raft-rs's own LeaseBased caveat:
    unbounded clock drift), let the majority elect and commit, then force a
    lease serve.  The other groups run the same workload fault-free, so the
    captured group ids must be exactly `offenders` (default: the odd group
    ids).  Runs on `cuda` unless `device` says otherwise."""
    from . import sim as sim_mod

    cfg = sim_mod.SimConfig(
        n_groups=n_groups, n_peers=n_peers, election_tick=election_tick,
        check_quorum=True, lease_read=True, blackbox=True,
        blackbox_window=4 * election_tick,
    )
    if offenders is None:
        offenders = [g for g in range(n_groups) if g % 2 == 1]
    session = TrapSession(cfg, device=device)
    G, P = n_groups, n_peers
    app = np.ones((G,), np.int32)
    for _ in range(settle_rounds):
        session.step(append_n=app)
    leads = session.sim.state.state.argmax(0).cpu().numpy()  # [G]
    link = np.ones((P, P, G), bool)
    freeze = np.zeros((P, G), bool)
    for g in offenders:
        for p in range(P):
            if p != leads[g]:
                link[leads[g], p, g] = False
                link[p, leads[g], g] = False
        freeze[leads[g], g] = True
    horizon = 3 * election_tick
    for r in range(horizon):
        fire = r == horizon - 1
        modes = np.full((G,), sim_mod.READ_LEASE if fire else 0, np.int32)
        session.step(
            append_n=app, link=link, read_modes=modes, freeze_mask=freeze,
        )
    return session


def run_commit_regress_trap(n_groups: int = 2, n_peers: int = 3,
                            offenders: Optional[Sequence[int]] = None,
                            settle_rounds: int = 20,
                            delta: int = 5,
                            device: DeviceLike = None) -> TrapSession:
    """The stale-commit-propagation trap: after a settled replicating
    stretch, a stale broadcast knocks one peer's commit cursor back `delta`
    entries in each offender group (default: the odd group ids).
    SV_COMMIT_REGRESSED must fire for exactly those groups, and the
    generated repro must replay RED on the scalar core (the same surgery on
    the real raft_log).  Runs on `cuda` unless `device` says otherwise."""
    from . import sim as sim_mod

    cfg = sim_mod.SimConfig(
        n_groups=n_groups, n_peers=n_peers, blackbox=True,
        blackbox_window=8,
    )
    if offenders is None:
        offenders = [g for g in range(n_groups) if g % 2 == 1]
    session = TrapSession(cfg, device=device)
    app = np.ones((n_groups,), np.int32)
    for _ in range(settle_rounds):
        session.step(append_n=app)
    # The trap round: regress a follower's cursor after the pump.
    session.step(
        append_n=app,
        regress={g: (2, delta) for g in offenders},
    )
    return session


# --- organic-failure capture for the report tools -------------------------


def capture_artifacts(sim, chaos_plan, out_dir: str,
                      stem: str = "incident") -> dict:
    """Incident JSON + generated repro off an ALREADY-RUN blackbox sim:
    the shared tail of every report tool's on-failure hook.  The repro's
    schedule column comes from the chaos plan's host twin
    (chaos.HostSchedule); runs that composed more than the fault
    schedule (reconfig ops, autopilot actions) still get the full
    incident JSON, and their repro replays the fault column alone — a
    NOT-REPRODUCED outcome there is recorded honestly and points the
    debugging at the composed machinery."""
    from . import chaos as chaos_mod

    if isinstance(chaos_plan, dict):
        chaos_plan = chaos_mod.plan_from_dict(chaos_plan)
    sched = chaos_mod.HostSchedule(chaos_plan, sim.cfg.n_groups)
    return extract_repro(
        sim, functools.partial(schedule_records, sched), out_dir,
        stem=stem,
    )


def report_failures(to_capture: Dict, out: dict, capture_fn) -> None:
    """The shared on-failure tail of the CI report tools: for each
    failing scenario, run `capture_fn(name, *args)` (a tool-specific
    blackbox re-run returning extract_repro's dict), record the artifact
    summary under out["forensics"][name], and narrate to stderr — one
    copy of the reporting contract instead of three.  A capture failure
    is recorded, not raised: the report itself must survive."""
    import sys

    out["forensics"] = {}
    for name, args in to_capture.items():
        try:
            cap = capture_fn(name, *args)
            out["forensics"][name] = {
                k: cap[k]
                for k in (
                    "slot", "group", "round", "reproduced",
                    "incident_path", "scenario_path",
                )
            }
            verdict = (
                "REPRODUCED" if cap["reproduced"] else "device-only"
            )
            print(
                f"FORENSICS: {name}: {cap['slot']} first tripped by "
                f"group {cap['group']} at round {cap['round']} — "
                f"incident {cap['incident_path']}, repro "
                f"{cap['scenario_path']} ({verdict})",
                file=sys.stderr,
            )
        except Exception as exc:  # keep the report itself alive
            out["forensics"][name] = {"error": str(exc)}
            print(
                f"FORENSICS: {name}: capture failed: {exc}",
                file=sys.stderr,
            )


def capture_chaos_incident(plan, n_groups: int, out_dir: str,
                           damped: bool = False,
                           stem: str = "incident",
                           sim_kwargs: Optional[dict] = None,
                           device: DeviceLike = None) -> dict:
    """The report tools' on-failure hook: re-run a chaos scenario with
    the black box ON (bit-identical protocol evolution — the recorder is
    a pure observer), capture the offending (group, round) pairs, and
    write the incident JSON + generated repro scenario as CI artifacts.
    Returns extract_repro's dict plus the re-run's report."""
    from . import chaos as chaos_mod
    from . import sim as sim_mod

    if isinstance(plan, dict):
        plan = chaos_mod.plan_from_dict(plan)
    cfg = sim_mod.SimConfig(
        n_groups=n_groups, n_peers=plan.n_peers, collect_health=True,
        check_quorum=damped, pre_vote=damped, blackbox=True,
        **(sim_kwargs or {}),
    )
    sim = sim_mod.ClusterSim(cfg, chaos=plan, device=device)
    report = sim.run_plan()
    out = capture_artifacts(sim, plan, out_dir, stem=stem)
    out["report"] = report
    return out
