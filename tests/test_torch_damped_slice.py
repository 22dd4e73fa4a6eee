"""The check-quorum slice as a whole at test size, against the JAX package:
the path of `bench.py --check-quorum` at G=16, P=5 (election_tick 64,
init_state and a 192-round settle on the plain damped step, then k-round
blocks of fast_multi_round(count_fused)), with equal states, recent_active
included, and fused counts after every block.  JAX's damped kernel runs in
interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_sim import assert_states_equal

G, P, TICK = 16, 5, 64
SETTLE = 3 * TICK
KW = dict(n_groups=G, n_peers=P, election_tick=TICK, check_quorum=True)


@functools.lru_cache(maxsize=None)
def settled():
    """(JAX state, port state) after init and the settle, checked equal."""
    sim = tsim.ClusterSim(tsim.SimConfig(**KW), device="cpu")
    sim.run(SETTLE, None, torch.ones(G, dtype=torch.int32))
    jst = jsim.ClusterSim(jsim.SimConfig(**KW)).run(SETTLE, None, jnp.ones((G,), jnp.int32))
    assert_states_equal(jst, sim.state, "settled")
    return jst, sim.state


def run_slice(k, blocks):
    jst, tst = settled()
    crashed = np.zeros((P, G), bool)
    append = np.ones(G, np.int32)
    jfn = jax.jit(jps.fast_multi_round(
        jsim.SimConfig(**KW), k=k, interpret=True, count_fused=True))
    tfn = tfs.fast_multi_round(tsim.SimConfig(**KW), k=k, count_fused=True)
    tf, jf = 0, jnp.int32(0)
    for b in range(blocks):
        jst, jf = jfn(jst, jnp.asarray(crashed), jnp.asarray(append), jf)
        tst, tf = tfn(tst, torch.from_numpy(crashed), torch.from_numpy(append), tf)
        assert_states_equal(jst, tst, f"block {b}")
        assert int(jf) == tf
    assert tf == blocks * k * G  # the settled fleet stays on the fused path
    assert (tst.commit.amax(0) > SETTLE - 2 * TICK).all()
    assert tst.recent_active.any()


def test_check_quorum_slice_k8():
    run_slice(8, 10)  # 80 rounds: every leader crosses its boundary


def test_check_quorum_slice_k32():
    run_slice(32, 3)
