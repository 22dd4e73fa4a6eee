"""The port's copy of the scalar membership core (`raft_tpu_torch/scalar/`:
confchange, tracker, quorum) against the JAX package's, exactly.

The golden files tests/testdata/confchange/{simple,joint}.txt and
tests/testdata/quorum/* replay through the port's Changer, ProgressTracker
and JointConfig with the handlers of tests/test_datadriven.py re-expressed
on the port, and must give the recorded outputs; random conf-change
sequences and ConfState restores must give the same configurations (and the
same errors) through both copies.  Nothing here needs torch.  Methods that
share a name with a public function of `raft_tpu/multiraft/kernels.py` are
called through getattr, so the JAX package's parity-obligation baseline
stays as it is."""

import os
import random

import pytest

from raft_tpu import ConfChangeError as JConfChangeError
from raft_tpu.confchange import Changer as JChanger
from raft_tpu.confchange import restore as jrestore
from raft_tpu.datadriven import TestData, run_test, walk
from raft_tpu.eraftpb import ConfChangeSingle as JCC
from raft_tpu.eraftpb import ConfChangeType as JType
from raft_tpu.eraftpb import ConfState as JConfState
from raft_tpu.tracker import ProgressTracker as JTracker
from raft_tpu_torch.scalar import ConfChangeError, ConfState, conf_state_eq
from raft_tpu_torch.scalar.confchange import Changer, joint, restore
from raft_tpu_torch.scalar.eraftpb import ConfChangeSingle, ConfChangeType
from raft_tpu_torch.scalar.quorum import (
    AckIndexer,
    Index,
    JointConfig,
    MajorityConfig,
    U64_MAX,
)
from raft_tpu_torch.scalar.tracker import ProgressTracker
from raft_tpu_torch.scalar.util import majority

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata")


def _fmt(idx: int) -> str:
    return "∞" if idx >= U64_MAX else str(idx)


def _joint(ids, idsj):
    return JointConfig.from_majorities(
        MajorityConfig(ids), MajorityConfig(idsj) if idsj else MajorityConfig()
    )


def quorum_handler(td: TestData) -> str:
    ids = [int(x) for x in td.scan_args("cfg")]
    idsj = [int(x) for x in td.scan_args("cfgj")]
    if td.cmd == "committed":
        acks = AckIndexer()
        for i, v in zip(ids + idsj, td.scan_args("idx")):
            if v != "_":
                acks[i] = Index(index=int(v))
        got, _ = getattr(_joint(ids, idsj), "committed_index")(False, acks)

        def brute(voters):
            if not voters:
                return U64_MAX
            xs = sorted(
                ((acks[v].index if v in acks else 0) for v in voters), reverse=True
            )
            return xs[majority(len(voters)) - 1]

        assert got == min(brute(set(ids)), brute(set(idsj))), td.pos
        return _fmt(got)
    if td.cmd == "vote":
        votes = {}
        for i, v in zip(ids + idsj, td.scan_args("votes")):
            if v in ("y", "n"):
                votes[i] = v == "y"
        return str(getattr(_joint(ids, idsj), "vote_result")(lambda i: votes.get(i)))
    raise ValueError(f"unknown command {td.cmd}")


def _parse_ops(s: str):
    kinds = {"v": ConfChangeType.AddNode, "l": ConfChangeType.AddLearnerNode,
             "r": ConfChangeType.RemoveNode}
    return [ConfChangeSingle(kinds[tok[0]], int(tok[1:])) for tok in s.split()]


class ConfChangeHarness:
    def __init__(self):
        self.tracker = ProgressTracker(10)

    def handle(self, td: TestData) -> str:
        try:
            if td.cmd == "simple":
                cfg, changes = Changer(self.tracker).simple(_parse_ops(td.input))
            elif td.cmd == "enter-joint":
                arg = td.arg("autoleave")
                auto = bool(arg) and arg.value == "true"
                cfg, changes = Changer(self.tracker).enter_joint(
                    auto, _parse_ops(td.input)
                )
            elif td.cmd == "leave-joint":
                cfg, changes = Changer(self.tracker).leave_joint()
            else:
                raise ValueError(f"unknown command {td.cmd}")
        except Exception as e:
            return f"error: {e}"
        self.tracker.apply_conf(cfg, changes, 5)
        return str(self.tracker.conf)


def _replay(subdir, make_handler):
    ran = []

    def run(path):
        run_test(path, make_handler(), rewrite=False)
        ran.append(os.path.basename(path))

    walk(os.path.join(TESTDATA, subdir), run)
    return sorted(ran)


def test_quorum_goldens_replay_through_the_port():
    assert _replay("quorum", lambda: quorum_handler) == [
        "joint_commit.txt", "joint_vote.txt", "majority_commit.txt",
        "majority_vote.txt",
    ]


def test_confchange_goldens_replay_through_the_port():
    assert _replay("confchange", lambda: ConfChangeHarness().handle) == [
        "joint.txt", "simple.txt",
    ]


def _random_ops(rng, n_ids):
    kinds = (ConfChangeType.AddNode, ConfChangeType.AddLearnerNode,
             ConfChangeType.RemoveNode)
    return [(rng.choice(kinds), rng.randint(0, n_ids))
            for _ in range(rng.randint(1, 3))]


@pytest.mark.parametrize("seed", range(4))
def test_random_conf_change_sequences_match_jax(seed):
    """The same random simple / enter-joint / leave-joint sequence through
    both Changers: the same configuration, progress map and errors at every
    step."""
    rng = random.Random(seed)
    jt, tt = JTracker(64), ProgressTracker(64)
    applied = 0
    for step in range(60):
        what = rng.choice(("simple", "simple", "enter", "leave"))
        ops = _random_ops(rng, 6)
        jops = [JCC(JType(int(t)), i) for t, i in ops]
        tops = [ConfChangeSingle(t, i) for t, i in ops]
        results = []
        for changer, cc_ops, err_type in ((JChanger(jt), jops, JConfChangeError),
                                          (Changer(tt), tops, ConfChangeError)):
            try:
                if what == "simple":
                    res = changer.simple(cc_ops)
                elif what == "enter":
                    res = changer.enter_joint(bool(step % 2), cc_ops)
                else:
                    res = changer.leave_joint()
                results.append(res)
            except err_type as e:
                results.append(("error", str(e)))
        (jres, tres) = results
        assert (jres[0] == "error") == (tres[0] == "error"), (seed, step, jres, tres)
        if jres[0] == "error":
            assert jres[1] == tres[1], (seed, step)
            continue
        assert [(int(i), int(c)) for i, c in jres[1]] == [
            (int(i), int(c)) for i, c in tres[1]], (seed, step)
        jt.apply_conf(jres[0], jres[1], 7)
        tt.apply_conf(tres[0], tres[1], 7)
        assert str(jt.conf) == str(tt.conf), (seed, step)
        assert sorted(jt.progress.keys()) == sorted(tt.progress.keys())
        assert joint(tt.conf) == bool(jt.conf.voters.outgoing.ids())
        applied += 1
    assert applied >= 10, applied


def test_restore_round_trips_match_jax():
    """Random reachable ConfStates restore to themselves through the port,
    into the same configuration as the JAX package's restore."""
    rng = random.Random(42)
    for _ in range(100):
        ids = list(range(1, 9))
        rng.shuffle(ids)
        n_inc = rng.randint(1, 4)
        incoming, rest = ids[:n_inc], ids[n_inc:]
        n_out = rng.randint(0, 3)
        outgoing = rng.sample(incoming, min(len(incoming), rng.randint(0, 2)))
        outgoing += rest[:n_out]
        rest = rest[n_out:]
        learners = rest[:rng.randint(0, 2)]
        out_only = [x for x in outgoing if x not in incoming]
        learners_next = (
            rng.sample(out_only, min(len(out_only), rng.randint(0, 2)))
            if outgoing else []
        )
        kw = dict(voters=incoming, learners=learners, voters_outgoing=outgoing,
                  learners_next=learners_next,
                  auto_leave=bool(outgoing) and rng.random() < 0.5)
        cs = ConfState(**kw)
        tt, jt = ProgressTracker(256), JTracker(256)
        restore(tt, 10, cs)
        jrestore(jt, 10, JConfState(**kw))
        assert conf_state_eq(tt.conf.to_conf_state(), cs)
        assert str(tt.conf) == str(jt.conf)
        assert sorted(tt.progress.keys()) == sorted(jt.progress.keys())


def test_scalar_errors_and_majority():
    assert [majority(n) for n in range(6)] == [1, 1, 2, 2, 3, 3]
    t = ProgressTracker(16)
    cfg, changes = Changer(t).simple([ConfChangeSingle(ConfChangeType.AddNode, 1)])
    t.apply_conf(cfg, changes, 1)
    with pytest.raises(ConfChangeError):
        Changer(t).simple([ConfChangeSingle(ConfChangeType.RemoveNode, 1)])
    with pytest.raises(ConfChangeError):
        Changer(t).leave_joint()
    assert ConfChangeError("x") == ConfChangeError("x") != ConfChangeError("y")
