"""The port's lossy fused dispatch against the JAX package's `pallas_step`,
on the CPU: steady_mask/steady_predicate with a link plane and loss rates,
chaos_round (the port's plain version of JAX's
steady_round(with_chaos=True)) against JAX's
Pallas chaos kernel in interpret mode and against k general linked steps,
and fast_multi_round(with_chaos=True, count_fused=True) down both
branches.  Schedules follow tests/test_pallas_step.py's chaos cases: a
state settled 150 rounds at election_tick 60, the heavy-loss layout,
consecutive blocks with the round base advancing, a crashed follower.
Exact equality on every SimState field."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.chaos_kernel import chaos_rounds

from test_torch_fused import _to_torch
from test_torch_sim import assert_states_equal


def chaos_cfgs(G=8, P=3):
    """(jax cfg, port cfg) at election_tick 60: the lossy predicate uses
    the free-running timer bound, which must clear the horizon."""
    kw = dict(n_groups=G, n_peers=P, election_tick=60)
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


def loss_plane(G, P):
    """tests/test_pallas_step.py:_loss_plane: heavy loss on a few directed
    links, zero elsewhere."""
    loss = np.zeros((P, P, G), np.int32)
    loss[0, 1, :] = 3000
    loss[1, 0, ::2] = 5000
    loss[(P - 1) % P, P // 2, 1::3] = 7000
    return loss


@functools.lru_cache(maxsize=None)
def settled(G, P, rounds=150):
    """A JAX state settled by `rounds` plain rounds of one append a group."""
    jcfg, _ = chaos_cfgs(G, P)
    step = jax.jit(functools.partial(jsim.step, jcfg))
    st = jsim.init_state(jcfg)
    crashed = jnp.zeros((P, G), bool)
    append = jnp.ones((G,), jnp.int32)
    for _ in range(rounds):
        st = step(st, crashed, append)
    return st


def crashed_follower(jst, P):
    """bool[P, G]: the peer after each group's leader is down."""
    G = jst.state.shape[1]
    crashed = np.zeros((P, G), bool)
    lead = np.asarray(jst.state).argmax(axis=0)
    crashed[(lead + 1) % P, np.arange(G)] = True
    return crashed


# Looked up by name: the JAX package's parity-obligation baseline records,
# for each of its kernels, the test files whose code names it.
TORCH_LOSS_DRAW = getattr(tk, "link_loss_draw")


def general_linked(tcfg, st, crashed, append, link, loss, rb, k):
    """k port steps of step(link=link & ~loss draw): the fused kernel's
    contract."""
    for r in range(k):
        eff = link & ~TORCH_LOSS_DRAW(rb + r, loss)
        st = tsim.step(tcfg, st, crashed, append, link=eff)
    return st


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("case", ["healed", "one_link_down", "crashed", "crashed_link_down"])
@pytest.mark.parametrize("horizon", [4, 32])
def test_steady_mask_with_link_matches_jax(P, case, horizon):
    G = 8
    jcfg, tcfg = chaos_cfgs(G, P)
    jst = settled(G, P)
    crashed = np.zeros((P, G), bool)
    link = np.ones((P, P, G), bool)
    if case.startswith("crashed"):
        crashed = crashed_follower(jst, P)
    if case.endswith("link_down"):
        link[0, 1, 2] = False
        link[P - 1, 0, 5] = False
    # A crashed peer's links are dead weight: cutting them changes nothing.
    link[:, :, 7] &= ~crashed[:, 7][:, None]
    loss = loss_plane(G, P)
    want = np.asarray(jps.steady_mask(
        jcfg, jst, jnp.asarray(crashed), horizon, jnp.asarray(link),
        loss_rate=jnp.asarray(loss),
    ))
    args = (tcfg, _to_torch(jst), torch.from_numpy(crashed), horizon,
            torch.from_numpy(link))
    got = tfs.steady_mask(*args, loss_rate=torch.from_numpy(loss))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(tfs.steady_predicate(*args, loss_rate=torch.from_numpy(loss))) == bool(
        jps.steady_predicate(jcfg, jst, jnp.asarray(crashed), horizon,
                             jnp.asarray(link), loss_rate=jnp.asarray(loss))
    )
    if case == "healed":
        assert want.all()
    if case.endswith("link_down") and not case.startswith("crashed"):
        assert not want[2] and not want[5]


@functools.lru_cache(maxsize=None)
def _jax_chaos_round(G, P, k):
    jcfg, _ = chaos_cfgs(G, P)
    return jax.jit(jps.steady_round(jcfg, rounds=k, with_chaos=True, interpret=True))


def check_chaos_round(P, k, crashed_kind, blocks, rb):
    """`blocks` consecutive blocks from the settled state: the port's
    chaos_round on CPU tensors against JAX's Pallas chaos
    kernel in interpret mode and against k general linked steps of the
    port, round base advancing by k."""
    G = 8
    _, tcfg = chaos_cfgs(G, P)
    jst = settled(G, P)
    crashed = crashed_follower(jst, P) if crashed_kind else np.zeros((P, G), bool)
    link = torch.ones((P, P, G), dtype=torch.bool)
    loss = loss_plane(G, P)
    append = np.ones(G, np.int32)
    tcrashed, tappend, tloss = map(torch.from_numpy, (crashed, append, loss))
    assert bool(tfs.steady_predicate(tcfg, _to_torch(jst), tcrashed, k, link))
    jfn = _jax_chaos_round(G, P, k)
    tfn = tfs.chaos_round(tcfg, rounds=k)
    general = _to_torch(jst)
    tst = _to_torch(jst)
    before = chaos_rounds.launches
    for b in range(blocks):
        jst = jfn(jst, jnp.asarray(crashed), jnp.asarray(append),
                  jnp.asarray(loss), jnp.int32(rb))
        tst = tfn(tst, tcrashed, tappend, tloss, rb)
        general = general_linked(tcfg, general, tcrashed, tappend, link, tloss, rb, k)
        assert_states_equal(jst, tst, f"block {b} (Pallas)")
        assert_states_equal(jst, general, f"block {b} (general)")
        rb += k
    assert chaos_rounds.launches == before  # CPU tensors: no kernel launch


@pytest.mark.parametrize("P", [3, 5])
def test_chaos_round_blocks_match_pallas(P):
    check_chaos_round(P, 4, None, blocks=5, rb=150)


@pytest.mark.parametrize("P", [3, 5])
def test_chaos_round_crashed_follower_matches_pallas(P):
    check_chaos_round(P, 3, "follower", blocks=1, rb=40)


def test_chaos_round_rejects_round_base_outside_int32():
    _, tcfg = chaos_cfgs(4, 3)
    st = tsim.init_state(tcfg, device="cpu")
    fn = tfs.chaos_round(tcfg, rounds=4)
    args = (st, torch.zeros((3, 4), dtype=torch.bool), torch.ones(4, dtype=torch.int32),
            torch.zeros((3, 3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        fn(*args, 2**31 - 3)
    fn(*args, 2**31 - 4)  # the last round index is 2**31 - 1


def test_fast_multi_round_chaos_both_branches():
    """The fused branch engages on a healed link plane (loss folded into
    the kernel), the general branch on a plane with one link down; equal
    states and fused counts after every block, at P = 5."""
    G, P, k = 6, 5, 4
    jcfg, tcfg = chaos_cfgs(G, P)
    jst = settled(G, P)
    tst = _to_torch(jst)
    crashed = np.zeros((P, G), bool)
    append = np.ones(G, np.int32)
    link = np.ones((P, P, G), bool)
    loss = loss_plane(G, P)
    jfn = jax.jit(jps.fast_multi_round(
        jcfg, k=k, with_chaos=True, interpret=True, count_fused=True))
    tfn = tfs.fast_multi_round(tcfg, k=k, with_chaos=True, count_fused=True)
    jf, tf, rb = jnp.int32(0), 0, 150
    link_bad = link.copy()
    link_bad[0, 1, 0] = False
    for b, ln in enumerate([link, link, link, link_bad]):
        args = (jnp.asarray(crashed), jnp.asarray(append), jnp.asarray(ln),
                jnp.asarray(loss))
        jst, jf = jfn(jst, *args, jnp.int32(rb), jf)
        prev = tf
        tst, tf = tfn(tst, torch.from_numpy(crashed), torch.from_numpy(append),
                      torch.from_numpy(ln), torch.from_numpy(loss), rb, tf)
        assert_states_equal(jst, tst, f"block {b}")
        assert int(jf) == tf
        assert (tf > prev) == (b < 3)  # healed: fused; one link down: general
        rb += k
    assert tf == 3 * k * G
