"""The port's damped fused dispatch against the JAX package's `pallas_step`,
on the CPU: the damped arm of steady_mask (the rejection conditions of
tests/test_pallas_step.py's damped cases, the degenerate tick config and
the per-group lossy check-quorum bound), and fast_multi_round(count_fused)
down both branches for check_quorum, pre-vote alone, both, and check
quorum with chaos, JAX's Pallas damped kernel in interpret mode.  Exact
equality on every SimState field, recent_active included."""

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
from raft_tpu_torch.multiraft.damped_kernel import damped_rounds

from test_torch_damped_kernels import FLAGS, cfgs, settled_port, to_jax
from test_torch_sim import assert_states_equal

G, P, DK = 8, 3, 4


def masks_equal(jcfg, tcfg, tst, crashed, horizon, link=None, loss=None):
    """The port's and JAX's steady_mask on the same state; returns it."""
    want = np.asarray(jps.steady_mask(
        jcfg, to_jax(tst), jnp.asarray(crashed.numpy()), horizon,
        None if link is None else jnp.asarray(link.numpy()),
        loss_rate=None if loss is None else jnp.asarray(loss.numpy()),
    ))
    got = tfs.steady_mask(tcfg, tst, crashed, horizon, link, loss_rate=loss)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(tfs.steady_predicate(tcfg, tst, crashed, horizon, link, loss_rate=loss)) == bool(want.all())
    return want


@pytest.mark.parametrize("flags", ["cq", "pv", "cqpv"])
def test_damped_steady_mask_rejection_conditions(flags):
    """Boot (no leaders), a leader whose recent_active row lacks an active
    quorum, a crashed stale leader near its boundary, and on the lossy
    branch any role-leader near its boundary."""
    jcfg, tcfg = cfgs(G, P, flags)
    st = settled_port(G, P, flags)
    none = torch.zeros((P, G), dtype=torch.bool)
    for horizon in (1, DK):
        assert masks_equal(jcfg, tcfg, st, none, horizon).all()
    assert not masks_equal(jcfg, tcfg, tsim.init_state(tcfg, device="cpu"), none, 1).any()
    bare = st._replace(recent_active=torch.zeros((P, P, G), dtype=torch.bool))
    m = masks_equal(jcfg, tcfg, bare, none, DK)
    assert m.any() == (flags == "pv")  # pre-vote alone reads no row
    leaders = st.state.numpy().argmax(0)
    stale = np.zeros((P, G), bool)
    stale[(leaders[0] + 1) % P, 0] = True
    st_np, ee_np = st.state.clone(), st.election_elapsed.clone()
    st_np[(leaders[0] + 1) % P, 0] = 2
    ee_np[(leaders[0] + 1) % P, 0] = tcfg.election_tick - 1
    staled = st._replace(state=st_np, election_elapsed=ee_np)
    m = masks_equal(jcfg, tcfg, staled, torch.from_numpy(stale), DK)
    assert m[1:].all() and (m[0] == (flags == "pv"))
    link = torch.ones((P, P, G), dtype=torch.bool)
    ee2 = st.election_elapsed.clone()
    ee2[leaders, np.arange(G)] = 2
    ee2[leaders[0], 0] = tcfg.election_tick - 1
    near = st._replace(election_elapsed=ee2)
    m_lossy = masks_equal(jcfg, tcfg, near, none, DK, link)
    m_lossless = masks_equal(jcfg, tcfg, near, none, DK)
    assert m_lossy[1:].all() and m_lossless[0]
    assert m_lossy[0] == (flags == "pv")


def test_degenerate_tick_config_rejects_everything():
    for flags in FLAGS:
        kw = dict(n_groups=4, n_peers=3, election_tick=2, heartbeat_tick=2, **FLAGS[flags])
        jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
        st = tsim.init_state(tcfg, device="cpu")
        assert not masks_equal(jcfg, tcfg, st, torch.zeros((3, 4), dtype=torch.bool), 1).any()


def test_steady_mask_loss_rate_per_group():
    """Only groups with a nonzero loss rate keep the no-boundary bound; the
    loss-free ones fuse through their check-quorum boundary as on the
    lossless branch."""
    jcfg, tcfg = cfgs(G, P, "cq")
    st = settled_port(G, P, "cq")
    lead = st.state == 2
    st = st._replace(election_elapsed=torch.where(
        lead, tcfg.election_tick - 2, st.election_elapsed))
    crashed = torch.zeros((P, G), dtype=torch.bool)
    link = torch.ones((P, P, G), dtype=torch.bool)
    lossless = masks_equal(jcfg, tcfg, st, crashed, DK)
    rate = torch.where(torch.arange(G) % 2 == 0, 25, 0).to(torch.int32)
    rate = rate[None, None, :].expand(P, P, G).contiguous()
    got = masks_equal(jcfg, tcfg, st, crashed, DK, link, rate)
    assert not got[::2].any()
    np.testing.assert_array_equal(got[1::2], lossless[1::2])
    assert not masks_equal(jcfg, tcfg, st, crashed, DK, link).any()


def test_steady_mask_needs_recent_active():
    _, tcfg = cfgs(4, 3, "cq")
    st = tsim.init_state(tsim.SimConfig(4, 3), device="cpu")
    with pytest.raises(ValueError, match="recent_active"):
        tfs.steady_mask(tcfg, st, torch.zeros((3, 4), dtype=torch.bool))


@functools.lru_cache(maxsize=None)
def _jax_fast(flags, k, chaos, election_tick):
    jcfg, _ = cfgs(G, P, flags, election_tick)
    return jax.jit(jps.fast_multi_round(
        jcfg, k=k, with_chaos=chaos, interpret=True, count_fused=True))


@pytest.mark.parametrize("flags", ["cq", "pv", "cqpv"])
def test_fast_multi_round_both_branches(flags):
    """Fused blocks from the settled state, a block with the acting leader
    crashed in every third group (the general branch: check-quorum and
    pre-vote elections), then the recovery; equal states and fused counts
    after every block."""
    jcfg, tcfg = cfgs(G, P, flags)
    tst = settled_port(G, P, flags)
    jst = to_jax(tst)
    append = np.ones(G, np.int32)
    jfn = _jax_fast(flags, DK, False, 10)
    tfn = tfs.fast_multi_round(tcfg, k=DK, count_fused=True)
    leaders = tst.state.numpy().argmax(0)
    jf, tf, fused_blocks, launches = jnp.int32(0), 0, 0, damped_rounds.launches
    blocks = 14
    for b in range(blocks):
        crashed = np.zeros((P, G), bool)
        if b == 3:
            crashed[leaders[::3], np.arange(G)[::3]] = True
        prev = tf
        jst, jf = jfn(jst, jnp.asarray(crashed), jnp.asarray(append), jf)
        tst, tf = tfn(tst, torch.from_numpy(crashed), torch.from_numpy(append), tf)
        assert_states_equal(jst, tst, f"{flags} block {b}")
        assert int(jf) == tf
        fused_blocks += tf > prev
    assert damped_rounds.launches == launches  # CPU tensors: no launch
    assert 0 < fused_blocks < blocks


def test_fast_multi_round_chaos_both_branches():
    """check_quorum with chaos: the per-group lossy bound fuses blocks
    clear of the boundary and sends the others, and a block with a link
    down, to damped general steps under link & ~loss draw."""
    jcfg, tcfg = cfgs(G, P, "cq", 30)
    s = tsim.ClusterSim(tcfg, device="cpu")
    s.run(90, None, torch.ones(G, dtype=torch.int32))
    tst = s.state
    jst = to_jax(tst)
    crashed = np.zeros((P, G), bool)
    append = np.ones(G, np.int32)
    loss = np.zeros((P, P, G), np.int32)
    loss[0, 1, :] = 3000
    loss[1, 0, ::2] = 5000
    loss[:, :, ::4] = 0
    link = np.ones((P, P, G), bool)
    link_bad = link.copy()
    link_bad[0, 1, 0] = False
    jfn = _jax_fast("cq", DK, True, 30)
    tfn = tfs.fast_multi_round(tcfg, k=DK, with_chaos=True, count_fused=True)
    jf, tf, rb, fused, general = jnp.int32(0), 0, 90, 0, 0
    for b in range(12):
        ln = link_bad if b == 5 else link
        args = (crashed, append, ln, loss)
        jst, jf = jfn(jst, *map(jnp.asarray, args), jnp.int32(rb), jf)
        prev = tf
        tst, tf = tfn(tst, *map(torch.from_numpy, args), rb, tf)
        assert_states_equal(jst, tst, f"chaos block {b}")
        assert int(jf) == tf
        fused += tf > prev
        general += tf == prev
        rb += DK
    assert fused > 0 and general > 0
