"""The port's link-gated round (`step(link=)`, sim._linked_step) against the
JAX package's, field by field after every round, on the CPU.

Schedules follow tests/test_chaos_parity.py: the seeded link fuzz
(directed link flips, crash flips, periodic heal-all, appends from 0 to 2)
at P = 3 and 5 and on a joint configuration with a learner, the
crash-as-link special case, and the asymmetric partition whose deposed
follower re-campaigns forever; here the reference is JAX's step rather
than the scalar oracle.  Steps from random planes under random link
planes make every group its own scenario.  Every plane is int32 or bool,
so the tolerance is exact equality.  The JAX link path takes seconds to
compile per shape, so all cases share three configurations."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_sim import _jax_step, _masks, assert_states_equal
from test_torch_sim_fuzz import random_state

G = 64
JOINT = dict(voters=[1, 2, 3, 4], outgoing=[3, 4, 5], learners=[6])


@functools.lru_cache(maxsize=None)
def _jax_linked(P):
    cfg = jsim.SimConfig(n_groups=G, n_peers=P)
    return jax.jit(lambda st, c, a, link: jsim.step(cfg, st, c, a, link=link))


class Pair:
    """The JAX and the port state side by side, from init_state."""

    def __init__(self, P, masks=None):
        masks = masks or _masks(P, groups=G)
        self.P = P
        vm, om, lm = masks["voter"], masks["outgoing"], masks["learner"]
        self.jst = jsim.init_state(
            jsim.SimConfig(n_groups=G, n_peers=P),
            jnp.asarray(vm), jnp.asarray(om), jnp.asarray(lm),
        )
        self.sim = tsim.ClusterSim(
            tsim.SimConfig(n_groups=G, n_peers=P),
            torch.from_numpy(vm), torch.from_numpy(om), torch.from_numpy(lm),
            device="cpu",
        )
        self.step = _jax_linked(P)

    def round(self, crashed, append, link, note):
        """crashed bool[P, G], append int[G], link bool[P, P, G] or None."""
        crashed = np.ascontiguousarray(crashed)
        append = np.asarray(append, np.int32)
        if link is None:
            self.jst = _jax_step(self.P, False, G)(
                self.jst, jnp.asarray(crashed), jnp.asarray(append)
            )
            self.sim.run_round(torch.from_numpy(crashed), torch.from_numpy(append))
        else:
            link = np.ascontiguousarray(link)
            self.jst = self.step(
                self.jst, jnp.asarray(crashed), jnp.asarray(append), jnp.asarray(link)
            )
            self.sim.run_round(
                torch.from_numpy(crashed), torch.from_numpy(append),
                link=torch.from_numpy(link),
            )
        assert_states_equal(self.jst, self.sim.state, note)


def link_fuzz(pair, seed, rounds, flip=0.08, crashp=0.03):
    """tests/test_chaos_parity.py:run_link_fuzz's schedule, draw for draw.
    Returns the number of rounds in which some group changed term."""
    P = pair.P
    rng = np.random.RandomState(seed)
    link = np.ones((P, P, G), bool)
    crash = np.zeros((G, P), bool)
    elections = 0
    for r in range(rounds):
        for g in range(G):
            for _ in range(2):
                if rng.rand() < flip:
                    a, b = rng.randint(P), rng.randint(P)
                    if a != b:
                        link[a, b, g] ^= True
            if rng.rand() < crashp:
                crash[g, rng.randint(P)] ^= True
            if rng.rand() < 0.05:
                link[:, :, g] = True
                crash[g, :] = False
        app = rng.randint(0, 3, size=G)
        before = np.asarray(pair.jst.term).copy()
        pair.round(crash.T, app, link, f"link-fuzz seed {seed} round {r}")
        elections += int((np.asarray(pair.jst.term) != before).any())
    return elections


@pytest.mark.parametrize("seed", [0, 1])
def test_link_fuzz_p3(seed):
    assert link_fuzz(Pair(3), seed, 100) > 3


@pytest.mark.parametrize("seed", [10, 11])
def test_link_fuzz_p5(seed):
    assert link_fuzz(Pair(5), seed, 100) > 3


@pytest.mark.parametrize("seed", [0, 1])
def test_link_fuzz_joint_with_learner(seed):
    """Joint double-majority elections and a non-voting learner under link
    faults."""
    masks = _masks(6, JOINT["voters"], JOINT["outgoing"], JOINT["learners"], groups=G)
    assert link_fuzz(Pair(6, masks), seed, 90) > 3


def test_crash_mask_is_link_special_case():
    """The link path driven with crash-shaped planes (row and column down)
    matches the JAX link path, and ends where the crash-mask path does."""
    P = 3
    pair = Pair(P)
    plain = tsim.ClusterSim(tsim.SimConfig(n_groups=G, n_peers=P), device="cpu")
    crash = np.zeros((P, G), bool)
    for r in range(40):
        if r == 18:
            crash[0, ::2] = True  # even groups lose peer 1
        if r == 30:
            crash[:] = False
        app = np.full(G, 1 if r % 2 else 0)
        link = np.ones((P, P, G), bool)
        link &= ~crash[:, None, :] & ~crash[None, :, :]
        pair.round(crash, app, link, f"crash-special-case round {r}")
        plain.run_round(torch.from_numpy(crash.copy()),
                        torch.from_numpy(app.astype(np.int32)))
    for f in ("term", "state", "commit", "last_index", "last_term"):
        assert torch.equal(getattr(plain.state, f), getattr(pair.sim.state, f)), f


def test_asymmetric_partition_term_inflation():
    """A follower that receives nothing but sends everything re-campaigns
    forever: terms inflate in the disturbed groups only, in both packages
    alike."""
    P = 3
    pair = Pair(P)
    ones = np.ones(G, np.int32)
    for r in range(30):
        pair.round(np.zeros((P, G), bool), ones, None, f"settle round {r}")
    leader_row = np.argmax(np.asarray(pair.jst.state) == 2, axis=0)
    link = np.ones((P, P, G), bool)
    half = G // 2
    for g in range(half):
        link[:, (leader_row[g] + 1) % P, g] = False
    base = np.asarray(pair.jst.term).max(axis=0)
    for r in range(80):
        pair.round(np.zeros((P, G), bool), ones, link, f"asymmetric round {r}")
    term_now = pair.sim.state.term.amax(0).numpy()
    assert (term_now[:half] - base[:half] >= 3).all(), term_now - base
    assert (term_now[half:] == base[half:]).all()


@pytest.mark.parametrize("P,seed", [(3, 0), (3, 1), (5, 2), (5, 3)])
def test_random_states_under_random_links(P, seed):
    """Four rounds from random planes (roles, terms, timers near their
    timeouts, logs, tracker rows, joint and learner masks) under random
    directed link planes and crashes: every group is its own scenario, so
    each round takes every branch of the wave replay somewhere."""
    rng = np.random.default_rng(seed + 50)
    arrays = random_state(P, G, seed)
    jst = jsim.SimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = tsim.state_from_numpy(arrays, "cpu")
    tcfg = tsim.SimConfig(n_groups=G, n_peers=P)
    for r in range(4):
        crashed = rng.random((P, G)) < 0.15
        link = rng.random((P, P, G)) < 0.75
        link[:, :, ::4] = True  # a quarter of the groups fully connected
        append = rng.integers(0, 3, size=G).astype(np.int32)
        jst = _jax_linked(P)(jst, jnp.asarray(crashed), jnp.asarray(append),
                             jnp.asarray(link))
        tst = tsim.step(tcfg, tst, torch.from_numpy(crashed),
                        torch.from_numpy(append), link=torch.from_numpy(link))
        assert_states_equal(jst, tst, f"round {r}")
