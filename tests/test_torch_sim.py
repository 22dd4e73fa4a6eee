"""The PyTorch port's general step against the JAX package's
`raft_tpu.multiraft.sim.step`, field by field after every round, on the CPU.

Schedules follow test_sim_parity.py, test_sim_joint.py,
test_sim_learners.py and the storm schedule of test_sim_fuzz.py:
elections, split votes and re-elections, staggered crashes, leader crashes
and mass recoveries, joint (outgoing) and learner masks.  Every plane is int32 or bool,
so the tolerance is exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import sim as tsim

G = 8


@functools.lru_cache(maxsize=None)
def _jax_step(P, spmd=False, groups=G):
    cfg = jsim.SimConfig(n_groups=groups, n_peers=P, spmd=spmd)
    return jax.jit(functools.partial(jsim.step, cfg))


def _masks(P, voters=None, outgoing=(), learners=(), groups=G):
    voters = range(1, P + 1) if voters is None else voters
    m = {name: np.zeros((P, groups), bool) for name in ("voter", "outgoing", "learner")}
    for name, ids in (("voter", voters), ("outgoing", outgoing), ("learner", learners)):
        for i in ids:
            m[name][i - 1, :] = True
    return m


def assert_states_equal(want, got, note=""):
    """Every SimState field equal and of the reference's dtype."""
    for f in tsim.SimState._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f"{note} {f}"
            continue
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.dtype == w.dtype, f"{note} {f}: {g.dtype} != {w.dtype}"
        if not np.array_equal(w, g):
            bad = np.argwhere(w != g)[0]
            raise AssertionError(
                f"{note} field {f} differs at {tuple(bad)}: "
                f"jax={w[tuple(bad)]} torch={g[tuple(bad)]}"
            )


def run_parity(P, rounds, schedule, masks=None, spmd=False, groups=G):
    """Drive both packages through `schedule(r, state) -> (crashed [P, G]
    bool, append [G] int)` from init_state, where `state` is the JAX
    state entering round r; compare after every round.  Returns the number
    of rounds in which some peer campaigned."""
    masks = masks or _masks(P, groups=groups)
    jcfg = jsim.SimConfig(n_groups=groups, n_peers=P, spmd=spmd)
    tcfg = tsim.SimConfig(n_groups=groups, n_peers=P, spmd=spmd)
    vm, om, lm = masks["voter"], masks["outgoing"], masks["learner"]
    jst = jsim.init_state(jcfg, jnp.asarray(vm), jnp.asarray(om), jnp.asarray(lm))
    tst = tsim.init_state(
        tcfg, torch.from_numpy(vm), torch.from_numpy(om), torch.from_numpy(lm),
        device="cpu",
    )
    assert_states_equal(jst, tst, "init")
    jstep = _jax_step(P, spmd, groups)
    elections = 0
    for r in range(rounds):
        crashed, append = schedule(r, jst)
        append = np.asarray(append, np.int32)
        before = np.asarray(jst.term).copy()
        jst = jstep(jst, jnp.asarray(crashed), jnp.asarray(append))
        tst = tsim.step(tcfg, tst, torch.from_numpy(crashed), torch.from_numpy(append))
        assert_states_equal(jst, tst, f"round {r}")
        elections += int((np.asarray(jst.term) != before).any())
    return elections


def test_quiet_elections_p3():
    P = 3
    n = run_parity(P, 40, lambda r, st: (np.zeros((P, G), bool), np.zeros(G)))
    assert n > 0


def test_steady_appends_p5():
    P = 5

    def schedule(r, st):
        appends = np.full(G, (r % 3 == 0) * (1 + r % 2))
        return np.zeros((P, G), bool), appends

    assert run_parity(P, 50, schedule) > 0


@pytest.mark.parametrize("P,seed", [(3, 0), (3, 1), (5, 2)])
def test_staggered_crashes(P, seed):
    """Persistent crash bits flipped at random: minority and majority
    outages, leader crashes, recoveries with stale candidates."""
    rng = np.random.RandomState(seed)
    crashed = np.zeros((P, G), bool)

    def schedule(r, st):
        flip = rng.rand(P, G) < 0.04
        crashed[flip] = ~crashed[flip]
        return crashed.copy(), rng.randint(0, 3, size=G)

    assert run_parity(P, 80, schedule) > 1


def test_leader_crash_and_recovery_p3():
    P = 3

    def schedule(r, st):
        crashed = np.zeros((P, G), bool)
        if 25 <= r < 55:
            crashed[0, :] = True
        if 70 <= r < 90:
            crashed[1, :] = True
        return crashed, np.full(G, r % 2)

    run_parity(P, 100, schedule)


@pytest.mark.parametrize("incoming,outgoing", [([1, 2, 3], [3, 4, 5]), ([1, 2, 3], [2, 3, 4])])
def test_joint_config_crash_churn(incoming, outgoing):
    P = 5
    rng = np.random.RandomState(77)
    crashed = np.zeros((P, G), bool)

    def schedule(r, st):
        for g in range(G):
            if rng.rand() < 0.06:
                p = rng.randint(P)
                crashed[p, g] = not crashed[p, g]
        return crashed.copy(), rng.randint(0, 2, size=G)

    run_parity(P, 70, schedule, _masks(P, incoming, outgoing))


def test_learners_replicate_and_crash():
    P = 5

    def schedule(r, st):
        crashed = np.zeros((P, G), bool)
        if 30 <= r < 50:
            crashed[3, ::2] = True  # a learner in half the groups
            crashed[0, 1::2] = True  # a voter in the others
        return crashed, np.ones(G)

    run_parity(P, 60, schedule, _masks(P, [1, 2, 3], learners=[4, 5]))


def test_solo_voter_wins_while_crashed():
    """Phase C': a crashed sole voter still wins its election locally."""
    P = 3

    def schedule(r, st):
        crashed = np.zeros((P, G), bool)
        crashed[0, :] = r >= 5
        return crashed, np.ones(G)

    run_parity(P, 40, schedule, _masks(P, [1], learners=[2]))


def storm(seed, P, groups=G):
    """The fuzz suites' storm schedule (tests/test_sim_fuzz.py), drawing
    the same random sequence for a seed: per group and round, flip one
    peer's crash bit (8%), crash the current leader (4%) or recover
    everyone (2%); never all peers down.  Term inflation from isolated
    peers, deposed leaders still beating, and commit fast-forwards through
    vote traffic all occur."""
    rng = np.random.RandomState(seed)
    crashed = np.zeros((P, groups), bool)

    def schedule(r, st):
        role = np.asarray(st.state)
        for g in range(groups):
            roll = rng.rand()
            if roll < 0.08:
                p = rng.randint(P)
                crashed[p, g] = not crashed[p, g]
            elif roll < 0.12:
                leaders = np.where(role[:, g] == 2)[0]
                if len(leaders):
                    crashed[leaders[0], g] = True
            elif roll < 0.14:
                crashed[:, g] = False
            if crashed[:, g].all():
                crashed[rng.randint(P), g] = False
        return crashed.copy(), rng.randint(0, 3, size=groups)

    return schedule


@pytest.mark.parametrize(
    "P,seed,config",
    [(3, 11, "plain"), (5, 12, "plain"), (5, 13, "joint"), (4, 14, "learners")],
)
def test_storm_schedule(P, seed, config):
    masks = None
    if config == "joint":
        masks = _masks(P, [1, 2, 3], [3, 4, 5])
    elif config == "learners":
        masks = _masks(P, range(1, P), learners=[P])
    assert run_parity(P, 120, storm(seed, P), masks) > 10


@pytest.mark.parametrize("spmd", [False, True])
def test_spmd_form_matches(spmd):
    """The election phase run unconditionally (spmd) and behind the host
    `if` give the same states as the JAX step in the same form, and the two
    port forms agree with each other on election rounds."""
    P = 5
    rng = np.random.RandomState(5)
    crashed = np.zeros((P, G), bool)
    plan = []
    for r in range(45):
        flip = rng.rand(P, G) < 0.03
        crashed[flip] = ~crashed[flip]
        plan.append((crashed.copy(), rng.randint(0, 2, size=G)))
    assert run_parity(P, 45, lambda r, st: plan[r], spmd=spmd) > 1

    a = tsim.ClusterSim(tsim.SimConfig(G, P), device="cpu")
    b = tsim.ClusterSim(tsim.SimConfig(G, P, spmd=True), device="cpu")
    for c, ap in plan:
        a.run_round(torch.from_numpy(c), torch.from_numpy(ap))
        b.run_round(torch.from_numpy(c), torch.from_numpy(ap))
        for f in tsim.SimState._fields:
            x, y = getattr(a.state, f), getattr(b.state, f)
            assert (x is None and y is None) or torch.equal(x, y), f
