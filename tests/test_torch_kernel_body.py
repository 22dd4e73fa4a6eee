"""The CUDA kernel's body (csrc/steady_body.cuh) built for the host with
g++ and held bit-identical to the plain PyTorch version
(steady_rounds_reference): the only way to check the kernel's arithmetic
without a card.  Inputs are random planes (any roles, crashes and masks,
so every branch of the body is taken) and settled states, at ragged G."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from raft_tpu_torch.multiraft import _build
from raft_tpu_torch.multiraft import sim
from raft_tpu_torch.multiraft.steady_kernel import steady_rounds, steady_rounds_reference

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ is needed to build the host shim"
)


def _host_rounds(args, rounds, election_tick, heartbeat_tick):
    lib = _build.load_steady_host()
    P, G = args[0].shape
    args = [a.contiguous() for a in args]
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(6)]
    rc = lib.steady_round_host(
        *[t.data_ptr() for t in (*args, *outs)],
        G, P, rounds, election_tick, heartbeat_tick,
    )
    assert rc == 0
    return outs


def _random_inputs(P, G, seed):
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape=(P, G)):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int32))

    def bools(p):
        return torch.from_numpy(rng.random((P, G)) < p)

    state = ints(0, 3)
    return (
        state, ints(0, 5), ints(0, 12), ints(0, 3), ints(0, 40), ints(0, 5),
        ints(0, 40), ints(0, 40), bools(0.8), bools(0.9), bools(0.2),
        ints(0, 40, (G,)), ints(0, 3, (G,)),
    )


def _settled_inputs(P, G):
    cfg = sim.SimConfig(n_groups=G, n_peers=P)
    s = sim.ClusterSim(cfg, device="cpu")
    s.run(30, None, torch.ones(G, dtype=torch.int32))
    st = s.state
    crashed = torch.zeros((P, G), dtype=torch.bool)
    crashed[0, ::3] = True
    is_leader = (st.state == 2) & ~crashed
    f = is_leader.to(torch.int32)
    return (
        st.state, st.term, st.election_elapsed, st.heartbeat_elapsed,
        st.last_index, st.last_term,
        (st.matched * f[:, None, :]).sum(0, dtype=torch.int32), st.commit,
        st.voter_mask, st.voter_mask | st.learner_mask, crashed,
        (st.term_start_index * f).sum(0, dtype=torch.int32),
        torch.ones(G, dtype=torch.int32),
    )


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("source", ["random", "settled"])
def test_host_body_matches_reference(P, k, source):
    G = 37  # not a multiple of any block size
    args = _random_inputs(P, G, seed=P * 100 + k) if source == "random" else _settled_inputs(P, G)
    for ticks in ((10, 1), (6, 3)):
        want = steady_rounds_reference(
            *args, rounds=k, election_tick=ticks[0], heartbeat_tick=ticks[1]
        )
        got = _host_rounds(args, k, *ticks)
        for name, w, g in zip(("ee", "hb", "li", "lt", "matched", "commit"), want, got):
            assert w.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name} {ticks}")


@pytest.mark.parametrize("P", [1, 2, 4, 6, 7])
def test_host_body_every_instantiated_peer_count(P):
    args = _random_inputs(P, 19, seed=P)
    want = steady_rounds_reference(*args, rounds=5, election_tick=4, heartbeat_tick=2)
    got = _host_rounds(args, 5, 4, 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_host_body_rejects_unsupported_peer_count():
    lib = _build.load_steady_host()
    null = ctypes.c_void_p(0)
    assert lib.steady_round_host(*([null] * 19), 4, 8, 1, 10, 1) != 0


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    args = _settled_inputs(3, 16)
    kw = dict(rounds=4, election_tick=10, heartbeat_tick=1)
    before = steady_rounds.launches
    got = steady_rounds(*args, **kw)
    want = steady_rounds_reference(*args, **kw)
    assert steady_rounds.launches == before
    for w, g in zip(want, got):
        assert torch.equal(w, g)
