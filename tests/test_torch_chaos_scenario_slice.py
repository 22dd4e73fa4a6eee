"""This slice's two entry points end to end at G=16, P=5, against the JAX
package on the CPU, exactly.

  * bench.py --chaos examples/chaos/partition_heal.json [--check-quorum]:
    the repo's P=5 plan (120 rounds: settle, partition, directed link
    overrides with 50% loss on two links, a crash on even groups, heal)
    through the port's ClusterSim(chaos=).run_plan() against JAX's runner
    (chaos.make_runner, as bench_chaos calls it) from a fresh state: the
    report, every SimState field and the health planes.
  * bench.py --lossy 0.01 --check-quorum: election_tick 64 with
    check_quorum, a 192-round settle, then k=32 blocks of
    hybrid_multi_round(with_chaos=True, count_fused=True) over an all-up
    link plane with 1% loss on every directed link, the round base
    advancing, against JAX's hybrid_multi_round with its damped Pallas
    kernel in interpret mode (a k=32 build, 15-20 s): every field and the
    fused count after every block."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_sim import assert_states_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = os.path.join(ROOT, "examples", "chaos", "partition_heal.json")
G, P = 16, 5


@pytest.mark.parametrize("cq", [False, True], ids=["undamped", "check_quorum"])
def test_chaos_entry_point_matches_jax(cq):
    kw = dict(n_groups=G, n_peers=P, collect_health=True, check_quorum=cq)
    jcfg = jsim.SimConfig(**kw)
    jplan = jchaos.load_plan(PLAN)
    runner = jchaos.make_runner(jcfg, jchaos.compile_plan(jplan, G))
    jst, jh, stats, safety = runner(jsim.init_state(jcfg), jsim.init_health(jcfg))
    want = JMonitor.chaos_report(*jax.device_get((stats, safety)), jplan.n_rounds)
    sim = tsim.ClusterSim(tsim.SimConfig(**kw), chaos=tchaos.load_plan(PLAN), device="cpu")
    got = sim.run_plan()
    assert got == want and got["rounds"] == 120
    assert not any(got["safety"].values())
    assert_states_equal(jst, sim.state, "end of plan")
    np.testing.assert_array_equal(sim._health.planes.numpy(), np.asarray(jh.planes))
    assert sim._health.window_pos == int(jh.window_pos)


def test_lossy_check_quorum_entry_point_matches_jax():
    tick, k, blocks = 64, 32, 4
    settle = 3 * tick
    kw = dict(n_groups=G, n_peers=P, election_tick=tick, check_quorum=True)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    append = np.ones(G, np.int32)
    jst = jsim.ClusterSim(jcfg).run(settle, None, jnp.asarray(append))
    sim = tsim.ClusterSim(tcfg, device="cpu")
    sim.run(settle, None, torch.from_numpy(append))
    assert_states_equal(jst, sim.state, "settled")
    crashed = np.zeros((P, G), bool)
    link = np.ones((P, P, G), bool)
    loss = np.full((P, P, G), 100, np.int32)  # LOSS_SCALE // 100: 1%
    jfn = jax.jit(jps.hybrid_multi_round(
        jcfg, k=k, with_chaos=True, interpret=True, count_fused=True))
    tfn = tfs.hybrid_multi_round(tcfg, k=k, with_chaos=True, count_fused=True,
                                 device="cpu")
    jargs = tuple(map(jnp.asarray, (crashed, append, link, loss)))
    targs = tuple(map(torch.from_numpy, (crashed, append, link, loss)))
    tst, tf, jf, rb = sim.state, 0, jnp.int32(0), settle
    branches = []
    for b in range(blocks):
        jst, jf = jfn(jst, *jargs, jnp.int32(rb), jf)
        tst, tf = tfn(tst, *targs, rb, tf)
        branches.append(tfn.last_branch)
        assert_states_equal(jst, tst, f"block {b} ({tfn.last_branch})")
        assert int(jf) == tf, f"block {b}"
        rb += k
    # 16 groups fit the default 4,096 storm slots: never the slow branch.
    assert set(branches) <= {"pure", "split"}
    assert 0 < tf < blocks * k * G or "pure" in branches
    assert (tst.commit.amax(0) > settle - 2 * tick).all()
