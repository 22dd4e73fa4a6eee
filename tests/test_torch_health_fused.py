"""The instrumented fused rounds on the CPU, against the JAX package's
`pallas_step` with its Pallas kernels in interpret mode: steady_round,
chaos_round and damped_round with the counters and/or health extras (the
with_health kernel variant's ticks_since_commit row, the closed-form
counter and health folds, window resets inside and across blocks), from
settled states with and without a crashed follower and from random health
planes; and fast_multi_round(with_health, with_counters, count_fused) down
both branches for the plain, the lossy and the check-quorum
configurations.  Exact equality on every SimState field, the counter plane,
the four health planes and window_pos."""

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
from raft_tpu_torch.multiraft.damped_kernel import damped_rounds
from raft_tpu_torch.multiraft.steady_kernel import steady_rounds

from test_torch_damped_kernels import to_jax
from test_torch_health import assert_extras_equal
from test_torch_sim import assert_states_equal

G, P, K = 16, 3, 4
# kind -> (SimConfig flags, settle rounds); the lossy and damped predicates
# use the free-running timer bound, which must clear the horizon.
KINDS = {
    "plain": (dict(election_tick=10), 30),
    "chaos": (dict(election_tick=30), 90),
    "cq": (dict(election_tick=10, check_quorum=True), 40),
    "pv": (dict(election_tick=10, pre_vote=True), 40),
}
CHAOS_KINDS = ("chaos", "cq_chaos")


def _kind(kind):
    return "cq" if kind == "cq_chaos" else kind


def cfgs(kind):
    flags, _ = KINDS[_kind(kind)]
    kw = dict(n_groups=G, n_peers=P, health_window=8, **flags)
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


@functools.lru_cache(maxsize=None)
def settled(kind):
    """A state settled by the port's general rounds (equal to JAX's: the
    port's step tests) with one append a group."""
    _, tcfg = cfgs(kind)
    s = tsim.ClusterSim(tcfg, device="cpu")
    s.run(KINDS[_kind(kind)][1], None, torch.ones(G, dtype=torch.int32))
    return s.state


def loss_plane(seed):
    rng = np.random.default_rng(seed)
    loss = rng.integers(0, 4000, size=(P, P, G)).astype(np.int32)
    loss[:, :, ::3] = 0
    return loss


def random_extras(seed, window=8):
    """Random counters and health planes, window_pos anywhere in the
    window: every arm of the folds moves something."""
    rng = np.random.default_rng(seed)
    counters = rng.integers(0, 1000, size=tk.N_COUNTERS).astype(np.int32)
    planes = rng.integers(0, 9, size=(tk.N_HEALTH_PLANES, G)).astype(np.int32)
    return counters, planes, int(rng.integers(0, window))


def to_jax_health(th):
    return jsim.HealthState(jnp.asarray(th.planes.numpy()), jnp.int32(th.window_pos))


@functools.lru_cache(maxsize=None)
def _pallas(kind, with_counters, with_health):
    jcfg, _ = cfgs(kind)
    return jax.jit(jps.steady_round(
        jcfg, rounds=K, with_health=with_health, with_counters=with_counters,
        with_chaos=kind in CHAOS_KINDS, interpret=True))


def _port_round(kind, with_counters, with_health):
    _, tcfg = cfgs(kind)
    kw = dict(with_counters=with_counters, with_health=with_health)
    if kind == "plain":
        return tfs.steady_round(tcfg, K, **kw)
    if kind == "chaos":
        return tfs.chaos_round(tcfg, K, **kw)
    return tfs.damped_round(tcfg, K, with_chaos=kind in CHAOS_KINDS, **kw)


def _crashed_follower(st):
    crashed = torch.zeros((P, G), dtype=torch.bool)
    lead = st.state.eq(tk.ROLE_LEADER).to(torch.int64).argmax(0)
    idx = torch.arange(G)
    crashed[(lead + 1) % P, idx] = idx % 2 == 0
    return crashed


def check_blocks(kind, with_counters, with_health, crash, blocks=3, seed=0):
    st = settled(kind)
    crashed = _crashed_follower(st) if crash else torch.zeros((P, G), dtype=torch.bool)
    append = np.ones(G, np.int32)
    append[::5] = 0
    c0, planes0, pos0 = random_extras(seed)
    tc, th = torch.from_numpy(c0), tsim.HealthState(torch.from_numpy(planes0), pos0)
    jc, jh = jnp.asarray(c0), to_jax_health(th)
    jst = to_jax(st)
    jfn, tfn = _pallas(kind, with_counters, with_health), _port_round(
        kind, with_counters, with_health)
    launches = [(f.launches, f.health_launches)
                for f in (steady_rounds, chaos_rounds, damped_rounds)]
    rb = 200
    for b in range(blocks):
        jlead, tlead = (), ()
        if kind in CHAOS_KINDS:
            lr = loss_plane(b)
            jlead, tlead = (jnp.asarray(lr), jnp.int32(rb)), (torch.from_numpy(lr), rb)
        jex = ((jc,) if with_counters else ()) + ((jh,) if with_health else ())
        tex = ((tc,) if with_counters else ()) + ((th,) if with_health else ())
        jout = jfn(jst, jnp.asarray(crashed.numpy()), jnp.asarray(append), *jlead, *jex)
        tout = tfn(st, crashed, torch.from_numpy(append), *tlead, *tex)
        assert isinstance(tout, tuple) and len(tout) == 1 + len(tex)
        jst, st = jout[0], tout[0]
        assert_states_equal(jst, st, f"{kind} block {b}")
        if with_counters:
            jc, tc = jout[1], tout[1]
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc), err_msg=f"block {b}")
        if with_health:
            jh, th = jout[-1], tout[-1]
            assert_extras_equal(jc, jh, tc, th, f"{kind} block {b}")
        rb += K
    assert launches == [(f.launches, f.health_launches)
                        for f in (steady_rounds, chaos_rounds, damped_rounds)]
    return tc, th


@pytest.mark.parametrize("extras", ["counters", "health", "both"])
@pytest.mark.parametrize("crash", [False, True])
def test_steady_round_extras_match_pallas(extras, crash):
    tc, th = check_blocks("plain", extras != "health", extras != "counters", crash)
    if extras != "counters":
        # A leader held every round: leaderless 0; the groups without
        # appends (every fifth) stall, the others commit.
        assert not th.planes[tk.HP_LEADERLESS].any()
        assert (th.planes[tk.HP_SINCE_COMMIT][::5] > 0).all()


@pytest.mark.parametrize("kind", ["chaos", "cq", "pv", "cq_chaos"])
@pytest.mark.parametrize("crash", [False, True])
def test_fused_round_extras_match_pallas(kind, crash):
    check_blocks(kind, True, True, crash, seed=1 + crash)


def test_extras_arity_is_checked():
    _, tcfg = cfgs("plain")
    st = settled("plain")
    args = (st, torch.zeros((P, G), dtype=torch.bool), torch.ones(G, dtype=torch.int32))
    with pytest.raises(TypeError):
        tfs.steady_round(tcfg, K, with_health=True)(*args)
    assert isinstance(tfs.steady_round(tcfg, K)(*args), tsim.SimState)


# --- the dispatcher down both branches --------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fast(kind):
    jcfg, _ = cfgs(kind)
    return jax.jit(jps.fast_multi_round(
        jcfg, k=K, with_health=True, with_counters=True,
        with_chaos=kind in CHAOS_KINDS, interpret=True, count_fused=True))


@pytest.mark.parametrize("kind", ["plain", "chaos", "cq"])
def test_fast_multi_round_extras_both_branches(kind):
    """Fused blocks from the settled state, then the acting leader crashed
    in every third group for 11 blocks (the general branch: elections,
    vote splits, leaderless rounds), a block with a link down on the lossy
    path, then the recovery; equal states, counters, health and fused
    counts after every block."""
    _, tcfg = cfgs(kind)
    st = settled(kind)
    jst = to_jax(st)
    c0, planes0, pos0 = random_extras(7)
    tc, th = torch.from_numpy(c0), tsim.HealthState(torch.from_numpy(planes0), pos0)
    jc, jh = jnp.asarray(c0), to_jax_health(th)
    append = np.ones(G, np.int32)
    leaders = st.state.numpy().argmax(0)
    jfn = _jax_fast(kind)
    tfn = tfs.fast_multi_round(tcfg, k=K, with_chaos=kind in CHAOS_KINDS,
                               count_fused=True, with_health=True, with_counters=True)
    jf, tf, rb, fused, general = jnp.int32(0), 0, 200, 0, 0
    for b in range(16):
        crashed = np.zeros((P, G), bool)
        if 2 <= b < 13:
            crashed[leaders[::3], np.arange(G)[::3]] = True
        jlead = tlead = ()
        if kind in CHAOS_KINDS:
            link = np.ones((P, P, G), bool)
            if b == 14:
                link[0, 1, :] = False
            lr = loss_plane(b)
            jlead = (jnp.asarray(link), jnp.asarray(lr), jnp.int32(rb))
            tlead = (torch.from_numpy(link), torch.from_numpy(lr), rb)
        jst, jc, jh, jf = jfn(jst, jnp.asarray(crashed), jnp.asarray(append), *jlead,
                              jc, jh, jf)
        prev = tf
        st, tc, th, tf = tfn(st, torch.from_numpy(crashed), torch.from_numpy(append),
                             *tlead, tc, th, tf)
        assert_states_equal(jst, st, f"{kind} block {b}")
        assert_extras_equal(jc, jh, tc, th, f"{kind} block {b}")
        assert int(jf) == tf
        fused += tf > prev
        general += tf == prev
        rb += K
    assert fused > 0 and general > 0
    assert tc[tk.CTR_ELECTIONS_WON] > c0[tk.CTR_ELECTIONS_WON]


def test_fast_multi_round_health_only_and_bare():
    """bench.py --health's arm (health alone, with count_fused) and the
    bare arm keep their return shapes."""
    _, tcfg = cfgs("plain")
    st = settled("plain")
    args = (st, torch.zeros((P, G), dtype=torch.bool), torch.ones(G, dtype=torch.int32))
    out, h, f = tfs.fast_multi_round(tcfg, k=K, with_health=True, count_fused=True)(
        *args, tsim.init_health(tcfg, "cpu"), 0)
    assert isinstance(out, tsim.SimState) and isinstance(h, tsim.HealthState)
    assert f == K * G and h.window_pos == K
    bare = tfs.fast_multi_round(tcfg, k=K)(*args)
    assert isinstance(bare, tsim.SimState)
    assert torch.equal(bare.commit, out.commit)
    with pytest.raises(TypeError):
        tfs.fast_multi_round(tcfg, k=K, with_counters=True)(*args)
