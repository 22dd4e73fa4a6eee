"""The lossy slice as a whole at test size, against the JAX package: the
path of `bench.py --lossy 0.01` at G=16, P=5 (election_tick 64,
init_state and a 192-round settle on the plain step, then k-round blocks
of fast_multi_round(with_chaos=True) on an all-up link plane with 1% loss
on every directed link, the round base advancing), with equal states and
fused counts after every block.  JAX's chaos kernel runs in interpret
mode."""

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
LOSS = 100  # LOSS_SCALE // 100: 1% per directed link


def run_slice(k, blocks):
    kw = dict(n_groups=G, n_peers=P, election_tick=TICK)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    sim = tsim.ClusterSim(tcfg, device="cpu")
    append = torch.ones(G, dtype=torch.int32)
    sim.run(SETTLE, None, append)
    jst = jsim.ClusterSim(jcfg).run(SETTLE, None, jnp.ones((G,), jnp.int32))
    assert_states_equal(jst, sim.state, "settled")
    crashed = np.zeros((P, G), bool)
    link = np.ones((P, P, G), bool)
    loss = np.full((P, P, G), LOSS, np.int32)
    jfn = jax.jit(jps.fast_multi_round(
        jcfg, k=k, with_chaos=True, interpret=True, count_fused=True))
    tfn = tfs.fast_multi_round(tcfg, k=k, with_chaos=True, count_fused=True)
    jargs = tuple(map(jnp.asarray, (crashed, append.numpy(), link, loss)))
    targs = tuple(map(torch.from_numpy, (crashed, append.numpy(), link, loss)))
    tst, tf, jf, rb = sim.state, 0, jnp.int32(0), SETTLE
    for b in range(blocks):
        jst, jf = jfn(jst, *jargs, jnp.int32(rb), jf)
        tst, tf = tfn(tst, *targs, rb, tf)
        assert_states_equal(jst, tst, f"block {b}")
        assert int(jf) == tf
        rb += k
    assert tf == blocks * k * G  # the settled fleet stays on the fused path
    assert (tst.commit.amax(0) > SETTLE - 2 * TICK).all()


def test_lossy_slice_k8():
    run_slice(8, 4)


def test_lossy_slice_k32():
    run_slice(32, 2)
