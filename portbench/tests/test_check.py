"""The check: the frozen reference equals the program's round, a sound run
is correct, and the control and every planted fault are not."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, controls, harness
from portbench.reference import confchange as C
from portbench.reference import raft_step as R


@pytest.mark.parametrize("damped", [False, True])
def test_reference_equals_the_programs_round(damped):
    from raft_tpu_torch.multiraft import sim

    G, P = 400, 3
    kw = dict(election_tick=10, heartbeat_tick=2 if damped else 1,
              check_quorum=damped, pre_vote=damped)
    pc, rc = sim.SimConfig(n_groups=G, n_peers=P, **kw), R.Config(G, P, **kw)
    ps, rs = sim.init_state(pc, device="cpu"), R.init_state(rc, "cpu")
    assert check.mismatch(ps, rs) == 0
    rng = np.random.default_rng(3)
    for r in range(120):
        app = torch.from_numpy(np.minimum(rng.zipf(1.8, G), 8).astype(np.int32))
        on = (np.arange(G)[None] + np.arange(P)[:, None]) % 30 == (r // 40) % 30
        crashed = torch.from_numpy(on & (r % 40 < 14))
        if r == 90:
            ps, rs = sim.init_state(pc, device="cpu"), R.init_state(rc, "cpu")
        ps, rs = sim.step(pc, ps, crashed, app), R.step(rc, rs, crashed, app)
        assert check.mismatch(ps, rs) == 0, r
        assert check.guarantee_violations(rs) == 0
    idx = torch.tensor([3, 77, 399])
    sub = R.State(*[None if v is None else v[..., idx] for v in rs])
    whole = R.step(rc, rs, crashed, app)
    part = R.step(rc._replace(n_groups=3), sub, crashed[:, idx], app[idx], group_ids=idx)
    assert check.mismatch(R.State(*[None if v is None else v[..., idx] for v in whole]),
                          part) == 0


def run(workload, system=None, seed=2**31 + 7, seconds=0.6, n_groups=300):
    return harness.run_cell(workload, seed, seconds, False, t0=time.perf_counter(),
                            device="cpu", system=system, n_groups=n_groups)


CELLS = ["raftrs-1m-r3.ycsb", "tikv-1m-r3.ycsb", "tikv-1m-r3.store-loss", "raftrs-1m-r3.storm"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", ["raftrs-1m-r3.ycsb", "tikv-1m-r3.store-loss"])
def test_control_is_not_correct(workload):
    r = run(workload, controls.Control)
    assert not r["correct"]
    for name in ("settle_mismatch", "block_mismatch", "guarantee_violations"):
        assert r["checks"][name]["value"] > 0, name


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["raftrs-1m-r3.ycsb", "tikv-1m-r3.ycsb"])
def test_planted_fault_is_not_correct(workload, fault):
    r = run(workload, controls.SYSTEMS[fault])
    assert not r["correct"], (fault, r["checks"])


def test_settle_fault_is_caught_by_the_start_check():
    class BadSettle(controls.Program):
        def step(self, st, crashed, append):
            out = super().step(st, crashed, append)
            return out._replace(vote=out.vote * 0 + 1)

    r = run("raftrs-1m-r3.ycsb", BadSettle)
    assert r["checks"]["settle_mismatch"]["value"] > 0 and not r["correct"]


def test_a_stall_in_the_window_moves_every_end_to_end_metric():
    class Stall(controls.Program):
        """Sleeps in each block that starts from a restarted fleet."""

        def block(self, st, crashed, append, fused):
            if int(st.term.max()) == 0:
                time.sleep(0.4)
            return super().block(st, crashed, append, fused)

    seed = 2**31 + 99
    base = run("raftrs-1m-r3.storm", seed=seed, seconds=1.5)["metrics"]
    slow = run("raftrs-1m-r3.storm", Stall, seed=seed, seconds=1.5)["metrics"]
    v = lambda m, n: m[n]["value"]  # noqa: E731
    assert v(slow, "ticks_per_s") < v(base, "ticks_per_s")
    assert v(slow, "step_ms_p95") > v(base, "step_ms_p95") + 300
    assert v(slow, "recover_ms_p95") > v(base, "recover_ms_p95") + 300


def old_guarantee_count(post, pre=None) -> int:
    """The guarantee count before configurations stated their membership:
    a commit's holders over every slot against P // 2 + 1, agree[p, p] as
    p's own log."""
    P = post.commit.shape[0]
    held = (post.agree >= post.commit[:, None, :]).sum(1)
    bad = int(((post.commit > 0) & (held < P // 2 + 1)).sum())
    bad += int((post.commit > post.last_index).sum())
    lead = post.state == R.ROLE_LEADER
    for p in range(P):
        for q in range(p + 1, P):
            bad += int((lead[p] & lead[q] & (post.term[p] == post.term[q])).sum())
    if pre is not None:
        bad += int((post.commit < pre.commit).sum())
    return bad


def hand_built(P, voters, learners=(), outgoing=(), commit=5, holders=(), leader=1):
    """One group: the leader's commit `commit`, held (agreement and log)
    by `holders` (1-based slots); the others hold one entry less."""
    st = R.init_state(R.Config(1, P), "cpu")
    mask = lambda slots: torch.tensor([[p + 1 in slots] for p in range(P)])  # noqa: E731
    last = torch.tensor([[commit if p + 1 in holders else commit - 1] for p in range(P)],
                        dtype=torch.int32)
    agree = torch.minimum(last[:, None, :], last[None, :, :])
    commits = torch.zeros((P, 1), dtype=torch.int32)
    commits[leader - 1] = commit
    state = torch.zeros((P, 1), dtype=torch.int32)
    state[leader - 1] = R.ROLE_LEADER
    return st._replace(last_index=last, commit=commits, agree=agree, state=state,
                       term=torch.ones((P, 1), dtype=torch.int32), voter_mask=mask(voters),
                       learner_mask=mask(learners), outgoing_mask=mask(outgoing))


def test_two_of_three_voters_hold_a_commit_without_the_learner():
    st = hand_built(4, voters=(1, 2, 3), learners=(4,), holders=(1, 2))
    assert check.guarantee_violations(st) == 0
    # the count over every slot flagged it: 2 of 4 slots
    assert old_guarantee_count(st) == 1


def test_a_voter_and_a_learner_do_not_make_a_majority():
    st = hand_built(4, voters=(1, 2, 3), learners=(4,), holders=(1, 4))
    assert check.guarantee_violations(st) == 1
    # nor a voter and an empty slot's stale log
    st = hand_built(4, voters=(1, 2, 3), holders=(1, 4))
    assert check.guarantee_violations(st) == 1


def test_a_joint_commit_needs_the_outgoing_majority():
    joint = dict(voters=(2, 3, 4), outgoing=(1, 2, 3), leader=3)
    st = hand_built(4, holders=(3, 4), **joint)  # the incoming majority alone
    assert check.guarantee_violations(st) == 1
    assert old_guarantee_count(st) == 1  # 2 of 4 slots, by chance alike
    st = hand_built(4, holders=(2, 3), **joint)  # both majorities
    assert check.guarantee_violations(st) == 0
    st = hand_built(5, holders=(1, 3, 5), voters=(2, 3, 4), outgoing=(1, 2, 3), leader=3)
    assert check.guarantee_violations(st) == 1  # 3 of 5 slots: passed the old count
    assert old_guarantee_count(st) == 0


def test_a_commit_that_predates_a_conf_change_is_held_to_election_safety():
    # A joint configuration entered under {1, 2, 3} with slot 3 behind: the
    # commit lacks the new incoming majority {2, 3}, yet every majority of
    # the outgoing half holds it, so no leader without it can be elected.
    st = hand_built(4, voters=(2, 3), outgoing=(1, 2, 3), holders=(1, 2), leader=2)
    assert check.guarantee_violations(st) == 1
    assert check.guarantee_violations(st, strict=torch.tensor([False])) == 0
    # slot 2 alone: every incoming majority ({2, 3}) still holds it
    st = hand_built(4, voters=(2, 3), outgoing=(1, 2, 3), holders=(2,), leader=2)
    assert check.guarantee_violations(st, strict=torch.tensor([False])) == 0
    # slot 1 alone: {2, 3} and {2, 3} of the outgoing half could elect without it
    st = hand_built(4, voters=(2, 3), outgoing=(1, 2, 3), holders=(1,), leader=1)
    assert check.guarantee_violations(st, strict=torch.tensor([False])) == 1


@pytest.mark.parametrize("workload", CELLS)
def test_all_voter_states_count_as_before(workload):
    """On every state the check reads in a cell (each block's input and
    output, sound and the control's) the count is the old one."""
    seen = []
    real = check.guarantee_violations

    def both(post, pre=None, strict=None):
        seen.append((old_guarantee_count(post, pre), real(post, pre, strict)))
        return seen[-1][1]

    check.guarantee_violations = both
    try:
        for system in (None, controls.Control):
            harness.run_cell(workload, 2**31 + 41, 0.6, False, t0=time.perf_counter(),
                             device="cpu", system=system, n_groups=300,
                             sampled_blocks=10**6)
    finally:
        check.guarantee_violations = real
    assert len(seen) > 20 and any(new > 0 for _, new in seen)
    assert all(old == new for old, new in seen)


def test_all_voter_random_states_count_as_before():
    rng = np.random.default_rng(8)
    for P in (3, 5, 7):
        G = 2000
        st = R.init_state(R.Config(G, P), "cpu")
        last = torch.from_numpy(rng.integers(0, 9, (P, G)).astype(np.int32))
        agree = torch.minimum(last[:, None], last[None]) - torch.from_numpy(
            rng.integers(0, 2, (P, P, G)).astype(np.int32))
        agree = torch.where(torch.eye(P, dtype=torch.bool)[:, :, None], last[:, None], agree)
        st = st._replace(last_index=last, agree=agree.clamp(min=0),
                         commit=torch.from_numpy(rng.integers(0, 10, (P, G)).astype(np.int32)),
                         state=torch.from_numpy(rng.integers(0, 3, (P, G)).astype(np.int32)),
                         term=torch.from_numpy(rng.integers(0, 3, (P, G)).astype(np.int32)))
        assert check.guarantee_violations(st) == old_guarantee_count(st) > 0


# Test-only kinds written as new files, for the conf-change arm's faults:
# chains and crashes set out block by block in the traffic file, in its
# first period.
SCRIPT = '''
import torch


def mask(slots, P, G, device):
    m = torch.zeros((P, G), dtype=torch.bool, device=device)
    for s in slots:
        m[s - 1] = True
    return m


class ConfChanges:
    def __init__(self, params, n_groups, n_peers, k, seed, device):
        self.period = params["every_rounds"]
        every = torch.ones(n_groups, dtype=torch.bool, device=device)
        self.requests = {int(r): (every,) + tuple(
            torch.stack([mask(step[i], n_peers, n_groups, device) for step in chain])
            for i in range(3)) for r, chain in params["chains"].items()}

    def at(self, round_no):
        return self.requests.get(round_no)
'''
CRASH_SCRIPT = '''
import torch

resets = False


def mask(slots, P, G, device):
    m = torch.zeros((P, G), dtype=torch.bool, device=device)
    for s in slots:
        m[s - 1] = True
    return m


class Faults:
    def __init__(self, params, n_groups, n_peers, k, seed, device):
        self.period = params["every_rounds"]
        self.down = {int(r): mask(s, n_peers, n_groups, device)
                     for r, s in params["crashed"].items()}

    def at(self, round_no):
        return self.down.get(round_no % self.period), None, False
'''
# Three voters and a learner, k = 8.  Block 0 enters a joint configuration
# (slot 4 promoted, slot 1 demoted); block 1 leaves it with slots 1 and 2
# down, so only the incoming half can hold the entry; block 3 enters
# another (slot 1 promoted, slot 2 demoted) with slots 2 and 4 down, the
# learner slot 1 alive; block 5 leaves it.
ARM_TRAFFIC = {
    "appends": {"dist": "ycsb_zipfian", "updates_per_group_round": 0.5,
                "keys_per_group": 1024, "theta": 0.99, "items": 10000000000, "rows": 16},
    "faults": {"kind": "crash_script", "every_rounds": 64,
               "crashed": {"8": [1, 2], "24": [2, 4]}},
    "confchanges": {"kind": "script", "every_rounds": 64, "chains": {
        "0": [[[2, 3, 4], [1, 2, 3], []]],
        "8": [[[2, 3, 4], [], [1]]],
        "24": [[[1, 3, 4], [2, 3, 4], []]],
        "40": [[[1, 3, 4], [], [2]]]}},
}


@pytest.fixture(scope="module")
def arm_cells(tmp_path_factory):
    """A copy of the benchmark with a plain and a check-quorum cell on the
    script traffic, added as files."""
    import json
    import shutil

    root = tmp_path_factory.mktemp("arm")
    pkg = Path(__file__).resolve().parents[1]
    shutil.copytree(pkg, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((pkg.parent / "BENCHMARK.json").read_text())
    (root / "portbench" / "confchanges").mkdir()
    (root / "portbench" / "confchanges" / "script.py").write_text(SCRIPT)
    (root / "portbench" / "faults" / "crash_script.py").write_text(CRASH_SCRIPT)
    (root / "portbench" / "traffic" / "arm.json").write_text(json.dumps(ARM_TRAFFIC))
    for name in ("raftrs-1m-r3", "tikv-1m-r3"):
        conf = json.loads((pkg / "configs" / f"{name}.json").read_text())
        conf.update(n_peers=4, voters=[1, 2, 3], learners=[4], block_rounds=8,
                    system="reconfig_runner")
        (root / "portbench" / "configs" / f"{name}-l4.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": f"{name}-l4", "source": "https://example.org/",
                                 "file": f"portbench/configs/{name}-l4.json",
                                 "reduced": [], "why": "a learner"})
        bench["workloads"].append({"name": f"{name}-l4.arm", "config": f"{name}-l4",
                                   "traffic": "arm", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


ARM_CELLS = ["raftrs-1m-r3-l4.arm", "tikv-1m-r3-l4.arm"]


def run_arm_cell(root, workload, system=None, seed=2**31 + 17):
    """One period of 8 blocks, each sampled (a fast fault runs more, of
    which 8 of each branch are)."""
    return harness.run_cell(workload, seed, 0.05, False, t0=time.perf_counter(), root=root,
                            device="cpu", system=system, n_groups=64, sampled_blocks=8)


@pytest.mark.parametrize("workload", ARM_CELLS)
@pytest.mark.parametrize("system", [None, "reference"])
def test_the_program_and_the_reference_run_the_script_correct(arm_cells, workload, system):
    if system == "reference":
        system = controls.arm_fault(C.Arm)
    r = run_arm_cell(arm_cells, workload, system)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] == 8


@pytest.mark.parametrize("fault", ["swap_early", "incoming_gate", "uncommitted",
                                   "learner_quorum", "control", "unchanged", "half",
                                   "altered"])
@pytest.mark.parametrize("workload", ARM_CELLS)
def test_arm_faults_are_not_correct(arm_cells, workload, fault):
    r = run_arm_cell(arm_cells, workload, controls.SYSTEMS[fault])
    assert not r["correct"], r["checks"]
