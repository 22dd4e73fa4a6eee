"""The slice as a whole at test size, against the JAX package: ClusterSim
settles 30 rounds of one append per group, then k=32 blocks go through
fast_multi_round (JAX's with its Pallas kernel in interpret mode), with
equal states and fused counts after every block."""

import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_fused import G, _jax_fast
from test_torch_sim import assert_states_equal


def test_slice_settle_then_blocks():
    """The main path at test size: ClusterSim settles 30 rounds of one
    append per group, then k=32 blocks through fast_multi_round."""
    P, k = 5, 32
    jfn = _jax_fast(P, k)
    tcfg = tsim.SimConfig(n_groups=G, n_peers=P)
    sim = tsim.ClusterSim(tcfg, device="cpu")
    append = torch.ones(G, dtype=torch.int32)
    sim.run(30, None, append)
    jsim_ = jsim.ClusterSim(jsim.SimConfig(n_groups=G, n_peers=P))
    jst = jsim_.run(30, None, jnp.ones((G,), jnp.int32))
    assert_states_equal(jst, sim.state, "settled")
    tfn = tfs.fast_multi_round(tcfg, k=k, count_fused=True)
    crashed = np.zeros((P, G), bool)
    tst, tf, jf = sim.state, 0, jnp.int32(0)
    for b in range(2):
        jst, jf = jfn(jst, jnp.asarray(crashed), jnp.asarray(append.numpy()), jf)
        tst, tf = tfn(tst, torch.from_numpy(crashed), append, tf)
        assert_states_equal(jst, tst, f"block {b}")
        assert int(jf) == tf
    assert tf == 2 * k * G
    assert (tst.commit > 30).all()


