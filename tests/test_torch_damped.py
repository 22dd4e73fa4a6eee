"""The port's damped round (sim._damped_linked_step, which `step` runs for
every check_quorum or pre_vote config) against the JAX package's, field by
field after every round, `recent_active` included, on the CPU.

Schedules follow tests/test_damping_parity.py: the scheduled mix (settle,
a symmetric split whose isolated leader must step down, a one-way link
with loss, heal) for check_quorum and for check_quorum with pre-vote; the
asymmetric-partition churn collapse and the isolated-leader step-down; the
seeded damped link fuzz at P = 3 and 5 for each flag set and on joint and
learner configurations.  Steps from random planes under random links at
G=64 make every group its own scenario.  Here the reference is JAX's step
rather than the scalar oracle.  Every plane is int32 or bool, so the
tolerance is exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import chaos
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import sim as tsim

from test_damping_parity import damped_plan
from test_torch_damped_kernels import FLAGS
from test_torch_sim import _masks, assert_states_equal
from test_torch_sim_fuzz import random_state

ROLE_LEADER = 2


@functools.lru_cache(maxsize=None)
def _jax_damped(G, P, flags):
    cfg = jsim.SimConfig(n_groups=G, n_peers=P, **FLAGS[flags])
    return jax.jit(lambda st, c, a, link: jsim.step(cfg, st, c, a, link=link))


class Pair:
    """The JAX and the port state side by side, from init_state."""

    def __init__(self, G, P, flags, masks=None):
        masks = masks or _masks(P, groups=G)
        vm, om, lm = masks["voter"], masks["outgoing"], masks["learner"]
        kw = dict(n_groups=G, n_peers=P, **FLAGS[flags])
        self.G, self.P = G, P
        self.jst = jsim.init_state(
            jsim.SimConfig(**kw), jnp.asarray(vm), jnp.asarray(om), jnp.asarray(lm)
        )
        self.sim = tsim.ClusterSim(
            tsim.SimConfig(**kw), torch.from_numpy(vm), torch.from_numpy(om),
            torch.from_numpy(lm), device="cpu",
        )
        assert_states_equal(self.jst, self.sim.state, "init")
        self.step = _jax_damped(G, P, flags)

    def round(self, crashed, append, link, note):
        """crashed bool[P, G], append int[G], link bool[P, P, G] or None
        (the port's default all-up plane; JAX gets it explicitly)."""
        crashed = np.ascontiguousarray(crashed, bool)
        append = np.asarray(append, np.int32)
        jlink = np.ones((self.P, self.P, self.G), bool) if link is None else link
        self.jst = self.step(
            self.jst, jnp.asarray(crashed), jnp.asarray(append),
            jnp.asarray(np.ascontiguousarray(jlink)),
        )
        self.sim.run_round(
            torch.from_numpy(crashed), torch.from_numpy(append),
            link=None if link is None else torch.from_numpy(np.ascontiguousarray(link)),
        )
        assert_states_equal(self.jst, self.sim.state, note)

    @property
    def state(self):
        return self.sim.state


@pytest.mark.parametrize("flags", ["cq", "cqpv"])
def test_scheduled_damped_mix(flags):
    G, P = 8, 3
    pair = Pair(G, P, flags)
    plan = damped_plan()
    sched = chaos.HostSchedule(plan, G)
    for r in range(plan.n_rounds):
        link, crashed, append = sched.masks(r)
        pair.round(crashed, append, link, f"{flags} scheduled round {r}")
    assert pair.state.recent_active.any()
    assert int(pair.state.commit.amax(0).min()) > 0


def disruptor_link(pair):
    """One follower per disturbed group (0-3) receives nothing but sends
    everything, after a 30-round settle."""
    G, P = pair.G, pair.P
    ones = np.ones(G, np.int32)
    for r in range(30):
        pair.round(np.zeros((P, G), bool), ones, None, f"settle round {r}")
    leader_row = np.argmax(pair.state.state.numpy() == ROLE_LEADER, axis=0)
    link = np.ones((P, P, G), bool)
    for g in range(4):
        link[:, (leader_row[g] + 1) % P, g] = False
    return leader_row, link


@pytest.mark.parametrize("flags", ["cq", "cqpv"])
def test_asymmetric_partition_churn_collapse(flags):
    """The damped half of the asymmetric-partition pathology: leases keep
    the sitting leader (check_quorum); pre-vote freezes terms entirely."""
    G, P = 8, 3
    pair = Pair(G, P, flags)
    leader_row, link = disruptor_link(pair)
    base_term = pair.state.term.amax(0).numpy()
    base_commit = pair.state.commit.amax(0).numpy()
    ones = np.ones(G, np.int32)
    deposed = np.zeros(G, np.int64)
    for r in range(80):
        pair.round(np.zeros((P, G), bool), ones, link, f"{flags} disruptor round {r}")
        deposed += pair.state.state.numpy()[leader_row, np.arange(G)] != ROLE_LEADER
    term_now = pair.state.term.amax(0).numpy()
    assert (deposed == 0).all(), deposed
    assert (pair.state.commit.amax(0).numpy() - base_commit >= 60).all()
    if flags == "cq":
        assert (term_now[:4] - base_term[:4] <= 6).all()
        assert (term_now[:4] > base_term[:4]).any()  # the disruptor inflates
        assert (term_now[4:] == base_term[4:]).all()
    else:
        assert (term_now == base_term).all()


def test_isolated_leader_steps_down():
    """A leader whose links are all cut steps down within two election
    ticks: the check-quorum boundary reads an empty recent_active row."""
    G, P = 8, 3
    pair = Pair(G, P, "cq")
    ones = np.ones(G, np.int32)
    for r in range(30):
        pair.round(np.zeros((P, G), bool), ones, None, f"settle round {r}")
    leader_row = np.argmax(pair.state.state.numpy() == ROLE_LEADER, axis=0)
    link = np.ones((P, P, G), bool)
    for g in range(G):
        link[leader_row[g], :, g] = False
        link[:, leader_row[g], g] = False
    for r in range(2 * 10 + 1):
        pair.round(np.zeros((P, G), bool), np.zeros(G), link, f"isolated round {r}")
    state = pair.state.state.numpy()
    assert (state[leader_row, np.arange(G)] != ROLE_LEADER).all()


def damped_link_fuzz(pair, seed, rounds, flip=0.08, crashp=0.03):
    """tests/test_damping_parity.py:run_damped_link_fuzz's schedule, draw
    for draw.  Returns the number of rounds in which some term changed."""
    G, P = pair.G, pair.P
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
        before = pair.state.term.clone()
        pair.round(crash.T, app, link.copy(), f"damped fuzz seed {seed} round {r}")
        elections += int(not torch.equal(before, pair.state.term))
    return elections


@pytest.mark.parametrize("flags", ["cq", "pv", "cqpv"])
@pytest.mark.parametrize("P,seed", [(3, 0), (3, 1), (5, 2)])
def test_damped_link_fuzz(flags, P, seed):
    assert damped_link_fuzz(Pair(8, P, flags), seed, 90) > 3


@pytest.mark.parametrize(
    "flags,P,voters,outgoing,learners",
    [
        ("cqpv", 5, [1, 2, 3], [3, 4, 5], []),  # joint
        ("cq", 4, [1, 2, 3], [], [4]),  # a learner
        ("pv", 4, [1, 2, 3], [], [4]),
        ("cqpv", 6, [1, 2, 3, 4], [3, 4, 5], [6]),  # joint with a learner
    ],
)
def test_damped_link_fuzz_joint_and_learners(flags, P, voters, outgoing, learners):
    masks = _masks(P, voters, outgoing, learners, groups=8)
    assert damped_link_fuzz(Pair(8, P, flags, masks), 30 + P, 70) > 3


@pytest.mark.parametrize("flags", ["cq", "pv", "cqpv"])
@pytest.mark.parametrize("P,seed", [(3, 0), (5, 1)])
def test_random_states_under_random_links(flags, P, seed):
    """Four rounds from random planes (roles including pre-candidates,
    terms, timers near their timeouts, logs, tracker and recent_active
    rows, joint and learner masks) under random link planes and crashes."""
    G = 64
    rng = np.random.default_rng(seed + 70)
    arrays = random_state(P, G, seed)
    arrays["state"] = rng.integers(0, 4, size=(P, G)).astype(np.int32)
    arrays["recent_active"] = rng.random((P, P, G)) < 0.6
    jst = jsim.SimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = tsim.state_from_numpy(arrays, "cpu")
    tcfg = tsim.SimConfig(n_groups=G, n_peers=P, **FLAGS[flags])
    step = _jax_damped(G, P, flags)
    for r in range(4):
        crashed = rng.random((P, G)) < 0.15
        link = rng.random((P, P, G)) < 0.75
        link[:, :, ::4] = True  # a quarter of the groups fully connected
        append = rng.integers(0, 3, size=G).astype(np.int32)
        jst = step(jst, jnp.asarray(crashed), jnp.asarray(append), jnp.asarray(link))
        tst = tsim.step(tcfg, tst, torch.from_numpy(crashed),
                        torch.from_numpy(append), link=torch.from_numpy(link))
        assert_states_equal(jst, tst, f"{flags} round {r}")


def test_damped_state_round_trip_and_errors():
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, check_quorum=True)
    st = tsim.init_state(cfg, device="cpu")
    assert st.recent_active.dtype == torch.bool and not st.recent_active.any()
    back = tsim.state_from_numpy(tsim.state_to_numpy(st), "cpu")
    assert back.recent_active.dtype == torch.bool
    crashed = torch.zeros((3, 4), dtype=torch.bool)
    append = torch.zeros(4, dtype=torch.int32)
    undamped = tsim.init_state(tsim.SimConfig(n_groups=4, n_peers=3), device="cpu")
    with pytest.raises(ValueError, match="recent_active"):
        tsim.step(cfg, undamped, crashed, append)
    # group_ids is ported: the iota as global ids is the whole batch.
    whole = tsim.step(cfg, st, crashed, append)
    gathered = tsim.step(cfg, st, crashed, append, group_ids=torch.arange(4))
    assert all(torch.equal(a, b) for a, b in zip(whole, gathered) if a is not None)
    # campaign_kick is ported: an all-False kick leaves the round unchanged.
    kicked = tsim.step(cfg, st, crashed, append,
                       campaign_kick=torch.zeros((3, 4), dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(whole, kicked) if a is not None)
    # read_propose is ported: the receipt comes last, the round unchanged.
    read, receipt = tsim.step(cfg, st, crashed, append,
                              read_propose=torch.zeros(4, dtype=torch.int32))
    assert isinstance(receipt, tsim.ReadReceipt) and (receipt.index == -1).all()
    assert all(torch.equal(a, b) for a, b in zip(whole, read) if a is not None)
    # The black box adds no SimState plane.
    bb = tsim.init_state(cfg._replace(blackbox=True), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(st, bb) if a is not None)
    # transfer is ported: the same state with an all-zero transferee plane,
    # which survives the numpy round trip.
    tr = tsim.init_state(cfg._replace(transfer=True), device="cpu")
    assert tr.transferee.dtype == torch.int32 and not tr.transferee.any()
    assert all(torch.equal(a, b) for a, b in zip(st, tr) if a is not None)
    assert torch.equal(tsim.state_from_numpy(tsim.state_to_numpy(tr), "cpu").transferee,
                       tr.transferee)
    # lease_read is ported: it builds the same state as check_quorum alone.
    leased = tsim.init_state(cfg._replace(lease_read=True), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(st, leased) if a is not None)
