"""The port's copy of the scalar Raft core against the JAX package's, on
seeded schedules: `raft_tpu_torch.multiraft.simref.ScalarCluster` (real
`Raft`s from `raft_tpu_torch/scalar/` on the copied harness) beside
`raft_tpu.multiraft.simref.ScalarCluster`, the same crashes, directed link
cuts and appends every round, with check_quorum and pre_vote off and on and
a joint bootstrap config: each peer's role, term, commit, last index and
last term equal round by round, and the acting leaders and the conf-entry
landing spots equal.  Then the copied datadriven parser on
tests/testdata/forensics/ and the forensics goldens' round blocks parsed
the same way by both packages."""

import os

import numpy as np
import pytest

from raft_tpu import datadriven as jdd
from raft_tpu.multiraft import simref as jref
from raft_tpu_torch.multiraft import simref as tref
from raft_tpu_torch.scalar import datadriven as tdd

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata")


def _schedule(rng, rounds, G, P, crash_p, link_p):
    for r in range(rounds):
        quiet = r < 12
        crashed = rng.rand(G, P) < (0.0 if quiet else crash_p)
        link = None
        if not quiet and link_p:
            link = rng.rand(P, P, G) > link_p
        append = rng.randint(0, 3, size=G).astype(np.int64)
        conf = rng.rand(G) < 0.1
        yield crashed, append, link, conf


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("damping", ["none", "check_quorum", "both"])
@pytest.mark.parametrize("links", [False, True], ids=["crashes", "links"])
def test_scalar_cluster_matches_reference(seed, damping, links):
    G, P, rounds = 3, 5 if seed else 3, 60
    kw = dict(election_tick=10, check_quorum=damping != "none",
              pre_vote=damping == "both", timeout_seed_base=7 * seed)
    if seed:
        kw.update(voters=[1, 2, 3], voters_outgoing=[3, 4, 5], learners=[])
    want, got = jref.ScalarCluster(G, P, **kw), tref.ScalarCluster(G, P, **kw)
    rng = np.random.RandomState(100 + seed)
    leaders = 0
    for r, (crashed, append, link, conf) in enumerate(
            _schedule(rng, rounds, G, P, 0.12, 0.15 if links else 0.0)):
        wp = want.round(crashed, append, link, conf_propose=conf)
        gp = got.round(crashed, append, link, conf_propose=conf)
        assert gp == wp, f"round {r}: conf entries"
        ws, gs = want.snapshot(), got.snapshot()
        for field in ("state", "term", "commit", "last_index", "last_term"):
            np.testing.assert_array_equal(gs[field], ws[field],
                                          err_msg=f"round {r} {field}")
        for g in range(G):
            lead = got.acting_leader(g, crashed[g])
            assert lead == want.acting_leader(g, crashed[g]), f"round {r} group {g}"
            leaders += lead is not None
    assert leaders > rounds * G // 3
    assert got.snapshot()["commit"].max() > 10


def test_kicks_match_reference():
    """The autopilot's campaign kick (a MsgHup after the tick) through both
    copies."""
    G, P = 2, 3
    want, got = jref.ScalarCluster(G, P), tref.ScalarCluster(G, P)
    rng = np.random.RandomState(9)
    for r in range(40):
        kick = rng.rand(G, P) < 0.1
        append = np.ones(G, np.int64)
        want.round(append_n=append, kick=kick)
        got.round(append_n=append, kick=kick)
        ws, gs = want.snapshot(), got.snapshot()
        for field in ("state", "term", "commit"):
            np.testing.assert_array_equal(gs[field], ws[field], err_msg=f"round {r}")


def _cases(dd, path):
    return [(c.pos, c.cmd, [(a.key, a.vals) for a in c.cmd_args], c.input, c.expected)
            for c in dd.parse_file(path)]


@pytest.mark.parametrize("name", ["clock_pause.txt", "commit_regress.txt"])
def test_datadriven_parses_as_reference(name):
    path = os.path.join(TESTDATA, "forensics", name)
    got = _cases(tdd, path)
    assert got == _cases(jdd, path)
    assert len(got) == 1 and got[0][1] == "repro"


def test_datadriven_walk_and_run_as_reference(tmp_path):
    """walk() visits the same files, and run_test() holds a handler's
    output against the expected block (a mismatch raises)."""
    seen = {"t": [], "j": []}
    tdd.walk(os.path.join(TESTDATA, "forensics"), seen["t"].append)
    jdd.walk(os.path.join(TESTDATA, "forensics"), seen["j"].append)
    assert seen["t"] == seen["j"] and len(seen["t"]) == 2
    case = tmp_path / "case.txt"
    case.write_text("echo a=1 b=(2,3)\nline\n----\nline a=1\n", encoding="utf-8")

    def handle(td):
        return f"{td.input} a={td.cmd_args[0].vals[0]}"

    tdd.run_test(str(case), handle)
    with pytest.raises(AssertionError):
        tdd.run_test(str(case), lambda td: "other")
