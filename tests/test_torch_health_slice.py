"""The instrumentation slice as a whole at test size, against the JAX
package: the path of `bench.py --health` at G=16, P=5 (init_state, a
30-round settle on the plain step, then k=32 blocks of
fast_multi_round(with_health=True, count_fused=True) threading the health
planes, as bench_device does), with equal states, health planes,
window_pos and fused counts after every block, and the end-of-run health
summary equal.  JAX's kernel runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_health import assert_extras_equal
from test_torch_sim import assert_states_equal

G, P, K, SETTLE, BLOCKS = 16, 5, 32, 30, 3
KW = dict(n_groups=G, n_peers=P)


def test_health_slice_k32():
    jcfg, tcfg = jsim.SimConfig(**KW), tsim.SimConfig(**KW)
    crashed = np.zeros((P, G), bool)
    append = np.ones(G, np.int32)
    tsm = tsim.ClusterSim(tcfg, device="cpu")
    tsm.run(SETTLE, torch.from_numpy(crashed), torch.from_numpy(append))
    jst = jsim.ClusterSim(jcfg).run(SETTLE, jnp.asarray(crashed), jnp.asarray(append))
    tst = tsm.state
    assert_states_equal(jst, tst, "settled")
    jfn = jax.jit(jps.fast_multi_round(
        jcfg, k=K, with_health=True, interpret=True, count_fused=True))
    tfn = tfs.fast_multi_round(tcfg, k=K, with_health=True, count_fused=True)
    jh, th = jsim.init_health(jcfg), tsim.init_health(tcfg, "cpu")
    jf, tf = jnp.int32(0), 0
    for b in range(BLOCKS):
        jst, jh, jf = jfn(jst, jnp.asarray(crashed), jnp.asarray(append), jh, jf)
        tst, th, tf = tfn(tst, torch.from_numpy(crashed), torch.from_numpy(append), th, tf)
        assert_states_equal(jst, tst, f"block {b}")
        assert_extras_equal(jnp.zeros(4, jnp.int32), jh, torch.zeros(4, dtype=torch.int32),
                            th, f"block {b}")
        assert int(jf) == tf
    assert tf == BLOCKS * K * G  # the settled fleet stays on the fused path
    summary = (tcfg.leaderless_stall_ticks, tcfg.commit_stall_ticks, tcfg.churn_bumps,
               min(tcfg.health_topk, G))
    want = getattr(jk, "health_summary")(jh.planes, *summary)
    got = getattr(tk, "health_summary")(th.planes, *summary)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][0]) == G  # every group committed in the last round
