"""The port's plain step against the JAX package's on the op mix of
tests/test_sim_fuzz_diff.py: per group and round a crash-bit flip (10%), a
targeted kill of the current leader (3%) or a mass recovery (3%), never
every peer down, and appends that burst to 0-4 in one round of five;
field by field after every round, at G=4, on the configurations of that
suite (plain, learners, joint)."""

import numpy as np
import pytest

from test_torch_sim import _masks, run_parity

G = 4


def op_mix(seed, P):
    """The differential fuzz's schedule, drawn in the same order."""
    rng = np.random.RandomState(seed)
    crashed = np.zeros((G, P), bool)

    def schedule(r, st):
        role = np.asarray(st.state)
        for g in range(G):
            roll = rng.rand()
            if roll < 0.10:
                p = rng.randint(P)
                crashed[g, p] = not crashed[g, p]
            elif roll < 0.13:
                leaders = np.where(role[:, g] == 2)[0]
                if len(leaders):
                    crashed[g, leaders[0]] = True
            elif roll < 0.16:
                crashed[g, :] = False
            if crashed[g].all():
                crashed[g, rng.randint(P)] = False
        burst = rng.rand() < 0.2
        append = rng.randint(0, 5 if burst else 2, size=G)
        return crashed.T.copy(), append

    return schedule


@pytest.mark.parametrize(
    "seed,P,config",
    [(0, 3, "plain"), (7, 3, "learners"), (11, 5, "joint"), (21, 5, "plain")],
)
def test_diff_fuzz_op_mix(seed, P, config):
    if config == "joint":
        masks = _masks(P, [1, 2, 3], [3, 4, 5], groups=G)
    elif config == "learners":
        masks = _masks(P, range(1, P), learners=[P], groups=G)
    else:
        masks = _masks(P, groups=G)
    assert run_parity(P, 96, op_mix(seed, P), masks, groups=G) > 3
