"""The port's per-group split, `fused_step.hybrid_multi_round`, and the
`step(group_ids=)` it runs on a gathered sub-batch, against the JAX
package on the CPU, exactly.

  * step(group_ids=): a gathered sub-batch stepped with its global group
    ids against JAX's step on the same sub-batch (plain, link-gated with
    the loss drawn by group_ids, and damped), round by round from boot so
    elections draw timeouts; each also equals the whole batch's step
    gathered at the same ids.
  * hybrid_multi_round against k sequential JAX sim.steps on
    tests/test_pallas_step.py's schedules: the localized storm (G=16, P=3,
    k=4, 4 slots), the overflow (8 groups, 1 slot), and the damped
    per-group chaos split (G=12, P=3, k=4, check_quorum and pre_vote,
    spread leader boundary phases, count_fused == k * the steady groups);
    plus the undamped lossy split (the chaos kernel's plain version) and
    the damped chaos overflow.  Every branch taken is named and checked.

On the CPU the fused branch runs each kernel's plain version; no Pallas
build is needed, since the reference side is the general step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_sim import assert_states_equal


def kfn(mod, name):
    return getattr(mod, name)


@functools.lru_cache(maxsize=None)
def jax_step(**kw):
    return jax.jit(functools.partial(jsim.step, jsim.SimConfig(**kw)))


def configs(**kw):
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


def gather(st, idx):
    return type(st)(*(None if v is None else v[..., idx] for v in st))


def jax_gather(st, idx):
    return type(st)(*(None if v is None else jnp.asarray(np.asarray(v)[..., idx])
                      for v in st))


FLAGS = {
    "plain": {},
    "linked": {},
    "damped": dict(check_quorum=True, pre_vote=True),
}


@pytest.mark.parametrize("kind", sorted(FLAGS))
def test_step_group_ids_matches_jax(kind):
    G, P, S = 12, 3, 5
    idx = np.asarray([9, 2, 7, 11, 4])
    flags = FLAGS[kind]
    _, tcfg = configs(n_groups=G, n_peers=P, **flags)
    sub_kw = dict(n_groups=S, n_peers=P, **flags)
    _, sub_tcfg = configs(**sub_kw)
    jstep = jax_step(**sub_kw)
    rng = np.random.RandomState(len(kind))
    whole = tsim.init_state(tcfg, device="cpu")
    tst = gather(whole, torch.from_numpy(idx))
    jst = jax_gather(jsim.init_state(jsim.SimConfig(n_groups=G, n_peers=P, **flags)), idx)
    assert_states_equal(jst, tst, "gathered init")
    loss = np.full((P, P, S), 2000, np.int32)
    for r in range(40):
        crashed = rng.rand(P, S) < 0.05
        append = rng.randint(0, 3, size=S).astype(np.int32)
        kw_j, kw_t = {}, {}
        if kind != "plain":
            drop_j = np.asarray(kfn(jk, "link_loss_draw")(
                jnp.int32(r), jnp.asarray(loss), group_ids=jnp.asarray(idx, jnp.int32)))
            drop_t = kfn(tk, "link_loss_draw")(r, torch.from_numpy(loss),
                                               group_ids=torch.from_numpy(idx))
            np.testing.assert_array_equal(drop_t.numpy(), drop_j)
            kw_j["link"] = jnp.asarray(~drop_j)
            kw_t["link"] = torch.from_numpy(~drop_j)
        jst = jstep(jst, jnp.asarray(crashed), jnp.asarray(append),
                    group_ids=jnp.asarray(idx, jnp.int32), **kw_j)
        tst = tsim.step(sub_tcfg, tst, torch.from_numpy(crashed),
                        torch.from_numpy(append), group_ids=torch.from_numpy(idx), **kw_t)
        assert_states_equal(jst, tst, f"{kind} round {r}")
    assert int(np.asarray(jst.term).max()) > 0  # elections drew timeouts

    # The same sub-batch inside the whole batch: the gathered step equals
    # the whole step gathered (groups are independent).
    t_idx = torch.from_numpy(idx)
    crashed = torch.zeros((P, G), dtype=torch.bool)
    append = torch.ones(G, dtype=torch.int32)
    for _ in range(25):
        whole = tsim.step(tcfg, whole, crashed, append)
    sub = tsim.step(sub_tcfg, gather(whole, t_idx), crashed[:, t_idx], append[t_idx],
                    group_ids=t_idx)
    want = gather(tsim.step(tcfg, whole, crashed, append), t_idx)
    for f in tsim.SimState._fields:
        a, b = getattr(sub, f), getattr(want, f)
        assert (a is None and b is None) or torch.equal(a, b), f


class Lockstep:
    """JAX's k sequential steps beside the port's hybrid_multi_round,
    states compared after every block."""

    def __init__(self, G, P, k, slots, with_chaos=False, **flags):
        self.G, self.P, self.k = G, P, k
        self.jcfg, self.tcfg = configs(n_groups=G, n_peers=P, **flags)
        self.jstep = jax_step(n_groups=G, n_peers=P, **flags)
        self.hybrid = tfs.hybrid_multi_round(
            self.tcfg, k=k, storm_slots=slots, with_chaos=with_chaos,
            count_fused=True, device="cpu")
        self.a = jsim.init_state(self.jcfg)
        self.b = tsim.init_state(self.tcfg, device="cpu")
        self.fused = 0
        self.branches = []

    def settle(self, rounds, append):
        for _ in range(rounds):
            crashed = np.zeros((self.P, self.G), bool)
            self.a = self.jstep(self.a, jnp.asarray(crashed), jnp.asarray(append))
            self.b = tsim.step(self.tcfg, self.b, torch.from_numpy(crashed),
                               torch.from_numpy(append))
        assert_states_equal(self.a, self.b, "settled")

    def block(self, crashed, append, link=None, loss=None, rb=0):
        before = self.fused
        for r in range(self.k):
            kw = {}
            if link is not None:
                drop = kfn(jk, "link_loss_draw")(jnp.int32(rb + r), jnp.asarray(loss))
                kw["link"] = jnp.asarray(link) & ~drop
            self.a = self.jstep(self.a, jnp.asarray(crashed), jnp.asarray(append), **kw)
        lead = () if link is None else tuple(map(torch.from_numpy, (link, loss))) + (rb,)
        self.b, self.fused = self.hybrid(
            self.b, torch.from_numpy(crashed.copy()), torch.from_numpy(append),
            *lead, self.fused)
        branch = self.hybrid.last_branch
        self.branches.append(branch)
        assert_states_equal(self.a, self.b, f"block {len(self.branches)} ({branch})")
        return branch, self.fused - before


def check_count(branch, delta, k, G):
    """The fused count of one block fits its branch: every group fused
    (pure), none (slow), or the steady ones only (split)."""
    if branch == "pure":
        assert delta == k * G
    elif branch == "slow":
        assert delta == 0
    else:
        assert branch == "split" and 0 <= delta < k * G and delta % k == 0


def test_hybrid_localized_storm_matches_k_steps():
    """A few groups storm (their leaders crash) while the rest stay steady:
    the storm groups ride the gathered general sub-batch, the rest the
    steady kernel's plain version (tests/test_pallas_step.py's schedule)."""
    G, P, k = 16, 3, 4
    run = Lockstep(G, P, k, slots=4)
    append = np.ones(G, np.int32)
    crashed = np.zeros((P, G), bool)
    for _ in range(8):  # the boot storm exceeds 4 slots: whole-batch general
        check_count(*run.block(crashed, append), k, G)
    leaders = np.asarray(run.a.state).argmax(axis=0)
    for g in (3, 11):
        crashed[leaders[g], g] = True
    for _ in range(6):
        check_count(*run.block(crashed, append), k, G)
    crashed[:] = False
    for _ in range(6):
        check_count(*run.block(crashed, append), k, G)
    assert {"pure", "split", "slow"} <= set(run.branches)


def test_hybrid_storm_overflow_falls_back():
    """More storm groups than slots: the exact whole-batch general step."""
    G, P, k = 8, 3, 3
    run = Lockstep(G, P, k, slots=1)
    crashed = np.zeros((P, G), bool)
    append = np.ones(G, np.int32)
    for _ in range(10):
        check_count(*run.block(crashed, append), k, G)
    assert run.branches[0] == "slow" and "pure" in run.branches


def set_leader_phases(run, phase):
    """Set each leader's election_elapsed to phase(g) in both packages
    (test_pallas_step.py's fixture, which spreads them as (g * 5) % tick):
    a lossy group whose boundary falls inside the horizon storms."""
    lead = np.asarray(run.a.state) == jk.ROLE_LEADER
    ee = np.asarray(run.a.election_elapsed).copy()
    for g in range(run.G):
        ee[lead[:, g], g] = phase(g)
    run.a = run.a._replace(election_elapsed=jnp.asarray(ee))
    run.b = run.b._replace(election_elapsed=torch.from_numpy(ee))


@pytest.mark.parametrize("phases", ["spread", "aligned"])
def test_hybrid_damped_chaos_per_group_split(phases):
    """The damped configuration (check_quorum and pre_vote) under loss on
    the even groups: with spread boundary phases only the lossy groups
    whose boundary falls in the horizon take the general wave path, keyed
    by their global ids in both seeded streams, and count_fused is exactly
    k * the steady groups; with every leader's boundary in the horizon the
    six lossy groups overflow the 4 slots to the whole-batch general
    branch.  Later blocks run whatever branch their state gives."""
    G, P, k, tick = 12, 3, 4, 16
    run = Lockstep(G, P, k, 4, with_chaos=True, election_tick=tick,
                   check_quorum=True, pre_vote=True)
    append = np.ones(G, np.int32)
    run.settle(3 * tick, append)
    set_leader_phases(run, (lambda g: (g * 5) % tick) if phases == "spread"
                      else (lambda g: tick - 2))
    crashed = np.zeros((P, G), bool)
    link = np.ones((P, P, G), bool)
    rate = np.where(np.arange(G) % 2 == 0, jk.LOSS_SCALE // 50, 0).astype(np.int32)
    loss = np.ascontiguousarray(np.broadcast_to(rate[None, None, :], (P, P, G)))
    mask = tfs.steady_mask(run.tcfg, run.b, torch.from_numpy(crashed), horizon=k,
                           link=torch.from_numpy(link), loss_rate=torch.from_numpy(loss))
    n_steady = int(mask.sum())
    branch, delta = run.block(crashed, append, link, loss, rb=100)
    if phases == "spread":
        assert 0 < n_steady < G
        assert branch == "split" and delta == k * n_steady
    else:
        assert n_steady == G - 6
        assert branch == "slow" and delta == 0
    for b in range(3):
        check_count(*run.block(crashed, append, link, loss, rb=104 + k * b), k, G)


def test_hybrid_undamped_lossy_split():
    """The undamped config under 1% loss with a link down in two groups:
    those groups take the gathered link-gated sub-batch, the rest the chaos
    kernel's plain version; then healed, the pure branch."""
    G, P, k, tick = 12, 3, 8, 64
    run = Lockstep(G, P, k, slots=4, with_chaos=True, election_tick=tick)
    append = np.ones(G, np.int32)
    run.settle(3 * tick, append)
    crashed = np.zeros((P, G), bool)
    loss = np.full((P, P, G), jk.LOSS_SCALE // 100, np.int32)
    link = np.ones((P, P, G), bool)
    cut = link.copy()
    cut[0, 1, [2, 7]] = False
    rb = 3 * tick
    branch, delta = run.block(crashed, append, cut, loss, rb)
    assert branch == "split" and delta == k * (G - 2)
    branch, delta = run.block(crashed, append, link, loss, rb + k)
    assert branch in ("pure", "split")
    check_count(branch, delta, k, G)


def test_hybrid_entry_point_defaults_to_cuda():
    cfg = tsim.SimConfig(4, 3)
    if torch.cuda.is_available():
        st = tsim.init_state(cfg)
        fn = tfs.hybrid_multi_round(cfg, k=2)
        fn(st, torch.zeros((3, 4), dtype=torch.bool, device="cuda"),
           torch.ones(4, dtype=torch.int32, device="cuda"))
    else:
        with pytest.raises(RuntimeError):
            tfs.hybrid_multi_round(cfg, k=2)
    fn = tfs.hybrid_multi_round(cfg, k=2, device="cpu")
    with pytest.raises(TypeError):
        fn(tsim.init_state(cfg, device="cpu"), torch.zeros((3, 4), dtype=torch.bool),
           torch.ones(4, dtype=torch.int32), 0)
