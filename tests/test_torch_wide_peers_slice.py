"""The port's steady path past P = 7 against raft_tpu's, its Pallas kernel in
interpret mode: from a settled state, two blocks of the port's
fast_multi_round equal the reference's fast_multi_round at P = 8 (k = 32),
and its steady_round at P = 16 (k = 4), 17 (k = 4) and 33 (k = 2) (on the
card the steady kernel's warp instance, where the reference's kernel has
no bound), both taking the fused branch; every SimState field, exact.  The
settled state comes from the port's general step (held to the
reference's by test_torch_sim.py).  A file of its own for the interpret
builds' compile time; past P = 33 an interpret build takes 28 s or more,
so the wider widths are held to the port's plain version
(test_torch_wide_peers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_sim import assert_states_equal

G = 8


def to_jax(st):
    return jsim.SimState(**{f: None if v is None else jnp.asarray(v)
                            for f, v in tsim.state_to_numpy(st).items()})


@pytest.mark.parametrize("P,k", [(8, 32), (16, 4), (17, 4), (33, 2)])
def test_fast_multi_round_past_seven_peers(P, k):
    cfg = tsim.SimConfig(n_groups=G, n_peers=P)
    s = tsim.ClusterSim(cfg, device="cpu")
    s.run(40, None, torch.ones(G, dtype=torch.int32))
    crashed = np.zeros((P, G), bool)
    append = np.ones(G, np.int32)
    append[::3] = 0
    jcfg = jsim.SimConfig(n_groups=G, n_peers=P)
    if P <= 15:
        jfast = jax.jit(jps.fast_multi_round(jcfg, k=k, interpret=True,
                                             count_fused=True))
    else:  # the fused round alone: the dispatcher's general branch would
        # double the compile
        jround = jax.jit(jps.steady_round(jcfg, rounds=k, interpret=True))

        def jfast(st, c, a, f):
            return jround(st, c, a), f + k * G
    tfast = tfs.fast_multi_round(cfg, k=k, count_fused=True)
    tst, fused, jfused = s.state, 0, 0
    for b in range(2):
        want, jfused = jfast(to_jax(tst), jnp.asarray(crashed), jnp.asarray(append),
                             jnp.int32(jfused))
        tst, fused = tfast(tst, torch.from_numpy(crashed.copy()),
                           torch.from_numpy(append), fused)
        assert_states_equal(want, tst, f"P={P} block {b}")
    assert fused == int(jfused) == 2 * k * G  # both on the fused branch
