"""The port's general step against the JAX package's on the fuzz seeds
that historically exposed divergences in the device step
(tests/test_sim_fuzz.py): the same storm schedule, seed for seed, at the
same group counts and configurations, compared field by field after
every round; and one step from random planes, where every group is its
own scenario."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_sim import _jax_step, _masks, assert_states_equal, run_parity, storm


@pytest.mark.parametrize(
    "seed,groups,P,voters,outgoing,learners",
    [
        (101, 3, 5, None, (), ()),  # candidate fast-forward via rejections
        (102, 3, 5, None, (), ()),  # stale lower-term requester
        (1004, 3, 4, None, (), ()),  # vote grants reset the voter's timer
        (209, 3, 5, [1, 2, 3], [3, 4, 5], ()),  # joint
        (2004, 2, 6, [1, 2, 3, 4], [3, 4, 5], [6]),  # deposed leader's heartbeat
        (2007, 2, 6, [1, 2, 3, 4], [3, 4, 5], [6]),  # bumps lower-term learners
        (5001, 2, 6, [1, 2, 3, 4], [3, 4, 5], [6]),  # a loser ignores later
        (5002, 2, 6, [1, 2, 3, 4], [3, 4, 5], [6]),  # responses' commit hints
        (7001, 2, 3, [1], (), [2, 3]),  # crashed singleton voter wins locally
    ],
)
def test_fuzz_regression_seed(seed, groups, P, voters, outgoing, learners):
    masks = _masks(P, voters, outgoing, learners, groups=groups)
    run_parity(P, 160, storm(seed, P, groups), masks, groups=groups)


def random_state(P, groups, seed):
    """Random planes for every SimState field (roles, terms, timers near
    their timeouts, logs, tracker rows, joint and learner masks): each
    group is an independent scenario, reachable or not, so one step takes
    every branch of the round somewhere in the batch."""
    rng = np.random.default_rng(seed)

    def ints(hi, shape=(P, groups), lo=0):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    voter = rng.random((P, groups)) < 0.7
    outgoing = (rng.random((P, groups)) < 0.5) & (rng.random(groups) < 0.3)
    learner = (rng.random((P, groups)) < 0.3) & ~voter & ~outgoing
    return {
        "term": ints(4), "state": ints(3), "vote": ints(P + 1),
        "leader_id": ints(P + 1), "election_elapsed": ints(21),
        "heartbeat_elapsed": ints(2), "randomized_timeout": ints(20, lo=10),
        "last_index": ints(12), "last_term": ints(4), "commit": ints(10),
        "matched": ints(12, (P, P, groups)), "term_start_index": ints(12),
        "agree": ints(12, (P, P, groups)), "voter_mask": voter,
        "outgoing_mask": outgoing, "learner_mask": learner,
    }


@pytest.mark.parametrize("P,seed", [(3, 0), (5, 1)])
def test_random_states(P, seed):
    groups = 256
    arrays = random_state(P, groups, seed)
    rng = np.random.default_rng(seed + 100)
    jst = jsim.SimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = tsim.state_from_numpy(arrays, "cpu")
    jstep = _jax_step(P, False, groups)
    tcfg = tsim.SimConfig(n_groups=groups, n_peers=P)
    for r in range(4):
        crashed = rng.random((P, groups)) < 0.2
        append = rng.integers(0, 3, size=groups).astype(np.int32)
        jst = jstep(jst, jnp.asarray(crashed), jnp.asarray(append))
        tst = tsim.step(tcfg, tst, torch.from_numpy(crashed), torch.from_numpy(append))
        assert_states_equal(jst, tst, f"round {r}")
