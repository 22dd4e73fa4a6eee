"""The kernel exports no device path calls, and the one-round dispatcher,
against raft_tpu's: committed_index_grouped, joint_committed_index,
vote_result, joint_vote_result and append_response_update on the random
cases of tests/test_multiraft_kernels.py (each also held to the scalar
quorum and tracker oracles there), and fused_step.fast_step against
pallas_step.fast_step (its Pallas kernel in interpret mode) on
tests/test_pallas_step.py's schedule of elections, crashes and recovery,
bare and with the health planes.  Exact.

The kernel functions, and the scalar oracle's methods of the same names,
are looked up by name: tests/test_sim_parity.py's obligation scan counts
the identifiers of every test file."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu.quorum import AckIndexer, Index, JointConfig, MajorityConfig
from raft_tpu.tracker import Progress
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.steady_kernel import steady_rounds

from test_torch_sim import assert_states_equal

P = 7  # padded peer width
INF = 2**31 - 1


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """CPU: the reference's Pallas kernels run in interpret mode."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def oracle(config, name, *args):
    """The scalar quorum oracle's method `name` (looked up by name too)."""
    return getattr(config, name)(*args)


def both(name, *arrays):
    """(reference's output, port's output) of kernel `name`, as numpy."""
    want = getattr(jk, name)(*(jnp.asarray(a) for a in arrays))
    got = getattr(tk, name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def assert_same(name, *arrays):
    want, got = both(name, *arrays)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def make_case(rng):
    voters = rng.sample(range(P), rng.randint(1, P))
    mask = np.zeros(P, dtype=bool)
    mask[voters] = True
    matched = np.array([rng.randint(0, 100) for _ in range(P)], dtype=np.int32)
    return mask, matched


def random_votes(rng):
    granted, rejected, votes = np.zeros(P, bool), np.zeros(P, bool), {}
    for i in range(P):
        r = rng.random()
        if r < 0.4:
            granted[i], votes[i + 1] = True, True
        elif r < 0.7:
            rejected[i], votes[i + 1] = True, False
    return granted, rejected, votes


def test_committed_index_grouped():
    rng = random.Random(9)
    masks, matcheds, groups, want_idx, want_flag = [], [], [], [], []
    for _ in range(400):
        mask, matched = make_case(rng)
        g = np.array([rng.randint(0, 3) for _ in range(P)], dtype=np.int32)
        masks.append(mask)
        matcheds.append(matched)
        groups.append(g)
        voters = [i + 1 for i in range(P) if mask[i]]
        ack = AckIndexer({i + 1: Index(index=int(matched[i]), group_id=int(g[i]))
                          for i in range(P)})
        wi, wf = oracle(MajorityConfig(voters), "committed_index", True, ack)
        want_idx.append(min(wi, INF))
        want_flag.append(wf)
    # Empty configs too: INF, and the group-commit flag set.
    masks.append(np.zeros(P, bool))
    matcheds.append(np.arange(P, dtype=np.int32))
    groups.append(np.ones(P, np.int32))
    want_idx.append(INF)
    want_flag.append(True)
    idx, flag = assert_same("committed_index_grouped", np.stack(matcheds),
                            np.stack(groups), np.stack(masks))
    np.testing.assert_array_equal(idx, np.asarray(want_idx, np.int32))
    np.testing.assert_array_equal(flag, np.asarray(want_flag))


def test_joint_committed_index():
    rng = random.Random(8)
    inc, out, matcheds, want = [], [], [], []
    for _ in range(300):
        imask, matched = make_case(rng)
        omask = np.zeros(P, dtype=bool)
        omask[rng.sample(range(P), rng.randint(0, P))] = True
        inc.append(imask)
        out.append(omask)
        matcheds.append(matched)
        ack = AckIndexer({i + 1: Index(index=int(matched[i])) for i in range(P)})
        joint = JointConfig.from_majorities(
            MajorityConfig([i + 1 for i in range(P) if imask[i]]),
            MajorityConfig([i + 1 for i in range(P) if omask[i]]))
        want.append(min(oracle(joint, "committed_index", False, ack)[0], INF))
    (got,) = assert_same("joint_committed_index", np.stack(matcheds),
                         np.stack(inc), np.stack(out))
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_vote_result():
    rng = random.Random(10)
    masks, gr, rj, want = [], [], [], []
    for _ in range(300):
        mask, _ = make_case(rng)
        granted, rejected, votes = random_votes(rng)
        masks.append(mask)
        gr.append(granted)
        rj.append(rejected)
        voters = [i + 1 for i in range(P) if mask[i]]
        want.append(int(oracle(MajorityConfig(voters), "vote_result", votes.get)))
    masks.append(np.zeros(P, bool))  # an empty config wins
    gr.append(np.zeros(P, bool))
    rj.append(np.ones(P, bool))
    want.append(int(oracle(MajorityConfig([]), "vote_result", lambda id: None)))
    (got,) = assert_same("vote_result", np.stack(gr), np.stack(rj), np.stack(masks))
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_joint_vote_result():
    rng = random.Random(11)
    inc, out, gr, rj, want = [], [], [], [], []
    for _ in range(300):
        imask, _ = make_case(rng)
        omask = np.zeros(P, dtype=bool)
        omask[rng.sample(range(P), rng.randint(0, P))] = True
        granted, rejected, votes = random_votes(rng)
        inc.append(imask)
        out.append(omask)
        gr.append(granted)
        rj.append(rejected)
        joint = JointConfig.from_majorities(
            MajorityConfig([i + 1 for i in range(P) if imask[i]]),
            MajorityConfig([i + 1 for i in range(P) if omask[i]]))
        want.append(int(oracle(joint, "vote_result", votes.get)))
    (got,) = assert_same("joint_vote_result", np.stack(gr), np.stack(rj),
                         np.stack(inc), np.stack(out))
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_append_response_update():
    rng = random.Random(12)
    matched = np.array([rng.randint(0, 50) for _ in range(P)], np.int32)
    next_idx = matched + 1
    resp_index = np.array([rng.randint(0, 80) for _ in range(P)], np.int32)
    resp_mask = np.array([rng.random() < 0.7 for _ in range(P)], bool)
    got_m, got_n = assert_same("append_response_update", matched, next_idx,
                               resp_index, resp_mask)
    for i in range(P):
        pr = Progress(int(next_idx[i]), 10)
        pr.matched = int(matched[i])
        if resp_mask[i]:
            pr.maybe_update(int(resp_index[i]))
        assert (int(got_m[i]), int(got_n[i])) == (pr.matched, pr.next_idx)


# --- fast_step ----------------------------------------------------------------


G, FP, ROUNDS = 8, 3, 45


def _to_torch(jst):
    return tsim.state_from_numpy(
        {f: np.asarray(v) for f, v in jst._asdict().items() if v is not None}, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_fast(with_health):
    cfg = jsim.SimConfig(n_groups=G, n_peers=FP, collect_health=with_health)
    return jax.jit(jps.fast_step(cfg, with_health=with_health))


@pytest.mark.parametrize("with_health", [False, True])
def test_fast_step_full_schedule(with_health):
    """fast_step == the reference's across elections, crashes and recovery
    (tests/test_pallas_step.py:test_fast_step_full_schedule_parity), round
    by round; both arms run."""
    jcfg = jsim.SimConfig(n_groups=G, n_peers=FP, collect_health=with_health)
    tcfg = tsim.SimConfig(n_groups=G, n_peers=FP, collect_health=with_health)
    jfast, tfast = _jax_fast(with_health), tfs.fast_step(tcfg, with_health=with_health)
    jst = jsim.init_state(jcfg)
    tst = _to_torch(jst)
    jh = jsim.HealthState(jnp.zeros((4, G), jnp.int32), jnp.int32(0))
    th = tsim.init_health(tcfg, "cpu")
    rng = np.random.RandomState(5)
    crashed = np.zeros((FP, G), bool)
    fused_before = steady_rounds.launches, steady_rounds.health_launches
    fused_rounds = 0
    for r in range(ROUNDS):
        if rng.rand() < 0.05:
            crashed[rng.randint(FP), rng.randint(G)] ^= True
        append = rng.randint(0, 2, size=G).astype(np.int32)
        fused_rounds += bool(tfs.steady_predicate(tcfg, tst, torch.from_numpy(crashed), 1))
        jargs = (jnp.asarray(crashed), jnp.asarray(append))
        targs = (torch.from_numpy(crashed.copy()), torch.from_numpy(append))
        if with_health:
            jst, jh = jfast(jst, *jargs, jh)
            tst, th = tfast(tst, *targs, th)
            np.testing.assert_array_equal(th.planes.numpy(), np.asarray(jh.planes))
            assert th.window_pos == int(jh.window_pos)
        else:
            jst, tst = jfast(jst, *jargs), tfast(tst, *targs)
        assert_states_equal(jst, tst, f"round {r}")
    assert 0 < fused_rounds < ROUNDS  # both arms ran
    # CPU tensors run the plain versions: no kernel launch.
    assert (steady_rounds.launches, steady_rounds.health_launches) == fused_before


def test_fast_step_fused_arm_is_steady_round_at_one():
    """On a settled state the fused arm equals steady_round(rounds=1) and a
    general step; a missing or extra health argument is refused."""
    cfg = tsim.SimConfig(n_groups=G, n_peers=FP)
    s = tsim.ClusterSim(cfg, device="cpu")
    append = torch.ones(G, dtype=torch.int32)
    s.run(30, None, append)
    crashed = torch.zeros((FP, G), dtype=torch.bool)
    assert bool(tfs.steady_predicate(cfg, s.state, crashed, 1))
    want = tsim.step(cfg, s.state, crashed, append)
    for got in (tfs.fast_step(cfg)(s.state, crashed, append),
                tfs.steady_round(cfg, 1)(s.state, crashed, append)):
        for f in want._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None and b is None) or torch.equal(a, b), f
    with pytest.raises(TypeError):
        tfs.fast_step(cfg)(s.state, crashed, append, None)
