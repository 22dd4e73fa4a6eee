"""The PyTorch port's steady dispatcher against the JAX package's
`pallas_step`, on the CPU: steady_mask/steady_predicate, steady_round
(JAX's Pallas kernel in interpret mode, the port's plain version) and
fast_multi_round over schedules where both branches run.  Exact equality
on every SimState field.  The k=32 steady_round cases are in
test_torch_fused_k32.py, the whole slice in test_torch_slice.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.steady_kernel import steady_rounds

from test_torch_sim import assert_states_equal

G = 16


def _to_torch(jst):
    return tsim.state_from_numpy(
        {f: np.asarray(v) for f, v in jst._asdict().items() if v is not None},
        "cpu",
    )


@functools.lru_cache(maxsize=None)
def _jax_step(P):
    return jax.jit(functools.partial(jsim.step, jsim.SimConfig(n_groups=G, n_peers=P)))


@functools.lru_cache(maxsize=None)
def settled(P, rounds=30):
    """A JAX state settled by `rounds` rounds of one append per group."""
    st = jsim.init_state(jsim.SimConfig(n_groups=G, n_peers=P))
    step = _jax_step(P)
    crashed = jnp.zeros((P, G), bool)
    append = jnp.ones((G,), jnp.int32)
    for _ in range(rounds):
        st = step(st, crashed, append)
    return st


def _inputs(P, kind):
    """(jax state, crashed numpy) for a named situation."""
    crashed = np.zeros((P, G), bool)
    if kind == "fresh":
        return jsim.init_state(jsim.SimConfig(n_groups=G, n_peers=P)), crashed
    st = settled(P)
    leaders = np.asarray(st.state) == 2
    if kind == "leader_crashed":
        crashed[:, ::2] = leaders[:, ::2]
    elif kind in ("follower_crashed", "follower_lagging"):
        lead = leaders.argmax(0)
        crashed[(lead + 1) % P, np.arange(G)] = True
    if kind == "follower_lagging":
        # The follower stays down for 3 general rounds first, so its log
        # tail and its agreement with the others are stale.
        step = _jax_step(P)
        append = jnp.ones((G,), jnp.int32)
        for _ in range(3):
            st = step(st, jnp.asarray(crashed), append)
    return st, crashed


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize(
    "kind",
    ["settled", "fresh", "leader_crashed", "follower_crashed", "follower_lagging"],
)
@pytest.mark.parametrize("horizon,hb_tick", [(1, 1), (32, 1), (4, 2)])
def test_steady_mask_matches_jax(P, kind, horizon, hb_tick):
    jst, crashed = _inputs(P, kind)
    jcfg = jsim.SimConfig(n_groups=G, n_peers=P, heartbeat_tick=hb_tick)
    tcfg = tsim.SimConfig(n_groups=G, n_peers=P, heartbeat_tick=hb_tick)
    want = np.asarray(jps.steady_mask(jcfg, jst, jnp.asarray(crashed), horizon))
    got = tfs.steady_mask(tcfg, _to_torch(jst), torch.from_numpy(crashed), horizon)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(tfs.steady_predicate(
        tcfg, _to_torch(jst), torch.from_numpy(crashed), horizon
    )) == bool(jps.steady_predicate(jcfg, jst, jnp.asarray(crashed), horizon))
    if kind in ("fresh", "leader_crashed"):
        assert not want.all()


@functools.lru_cache(maxsize=None)
def _jax_steady_round(P, k):
    cfg = jsim.SimConfig(n_groups=G, n_peers=P)
    return jax.jit(jps.steady_round(cfg, rounds=k, interpret=True))


def check_steady_round(P, k, kind):
    """The port's steady_round on CPU tensors (the plain version) against
    JAX's Pallas kernel in interpret mode, from the same state."""
    jst, crashed = _inputs(P, kind)
    cfg = tsim.SimConfig(n_groups=G, n_peers=P)
    if kind == "settled":
        assert bool(tfs.steady_predicate(
            cfg, _to_torch(jst), torch.from_numpy(crashed), k
        ))
    append = np.ones(G, np.int32)
    want = _jax_steady_round(P, k)(jst, jnp.asarray(crashed), jnp.asarray(append))
    before = steady_rounds.launches
    got = tfs.steady_round(cfg, rounds=k)(
        _to_torch(jst), torch.from_numpy(crashed), torch.from_numpy(append)
    )
    assert steady_rounds.launches == before  # CPU tensors: no kernel launch
    assert_states_equal(want, got, f"k={k}")


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["settled", "follower_crashed", "follower_lagging"])
def test_steady_round_matches_pallas(P, k, kind):
    check_steady_round(P, k, kind)


def _jax_fast(P, k):
    cfg = jsim.SimConfig(n_groups=G, n_peers=P)
    return jax.jit(jps.fast_multi_round(cfg, k=k, interpret=True, count_fused=True))


@pytest.mark.parametrize("P,k,blocks", [(3, 8, 8), (5, 8, 7)])
def test_fast_multi_round_from_init(P, k, blocks):
    """From init_state: the first blocks hold elections (general branch),
    later ones are steady (fused branch); equal states and fused counts
    after every block.  A crash window in the middle forces re-elections."""
    jfn = _jax_fast(P, k)
    tfn = tfs.fast_multi_round(tsim.SimConfig(n_groups=G, n_peers=P), k=k, count_fused=True)
    jst = jsim.init_state(jsim.SimConfig(n_groups=G, n_peers=P))
    tst = tsim.init_state(tsim.SimConfig(n_groups=G, n_peers=P), device="cpu")
    append = np.ones(G, np.int32)
    jf, tf = jnp.int32(0), 0
    fused_blocks = 0
    for b in range(blocks):
        crashed = np.zeros((P, G), bool)
        if b == blocks - 3:
            crashed[0, ::3] = True
        prev = tf
        jst, jf = jfn(jst, jnp.asarray(crashed), jnp.asarray(append), jf)
        tst, tf = tfn(tst, torch.from_numpy(crashed), torch.from_numpy(append), tf)
        assert_states_equal(jst, tst, f"block {b}")
        assert int(jf) == tf
        fused_blocks += tf > prev
    assert 0 < fused_blocks < blocks


def test_fused_dispatch_rejects_unported_options():
    cfg = tsim.SimConfig(n_groups=4, n_peers=3)
    st = tsim.init_state(cfg, device="cpu")
    crashed = torch.zeros((3, 4), dtype=torch.bool)
    # The transfer arm is ported: a state without a pending transfer passes.
    tr_cfg = cfg._replace(transfer=True)
    assert tfs.steady_mask(tr_cfg, st, crashed).shape == (4,)
    # reconfig_pending and read_pending are ported: each rejects exactly the
    # pending groups.
    sim = tsim.ClusterSim(cfg, device="cpu")
    sim.run(25, None, torch.ones(4, dtype=torch.int32))
    st = sim.state
    base = tfs.steady_mask(cfg, st, crashed)
    assert base.all()
    pending = torch.tensor([True, False, True, False])
    assert torch.equal(tfs.steady_mask(cfg, st, crashed, read_pending=pending),
                       base & ~pending)
    assert torch.equal(tfs.steady_mask(cfg, st, crashed, reconfig_pending=pending),
                       base & ~pending)
    assert torch.equal(tfs.steady_mask(cfg, st, crashed, reconfig_pending=~pending),
                       base & pending)
    with pytest.raises(NotImplementedError):
        tfs.fast_multi_round(cfg._replace(blackbox=True), k=4)
    # A pending transfer rejects exactly its group.
    tr_st = st._replace(transferee=torch.zeros((3, 4), dtype=torch.int32))
    assert torch.equal(tfs.steady_mask(tr_cfg, tr_st, crashed), base)
    tr_st = tr_st._replace(transferee=torch.tensor([[0, 2, 0, 0]] * 3, dtype=torch.int32))
    assert torch.equal(tfs.steady_mask(tr_cfg, tr_st, crashed),
                       base & torch.tensor([True, False, True, True]))
    assert callable(tfs.fast_multi_round(tr_cfg, k=4, with_chaos=True))
