"""The unified runner's split and cadence families on the CPU against the
JAX package, exactly: the golden scenarios of tests/test_runner_unified.py
at G=8.  Each legacy wrapper (reconfig.make_split_runner,
workload.make_split_runner, autopilot.make_cadence_runner) equals
runner.make_runner bit for bit, and both equal
raft_tpu.multiraft.runner.make_runner (whose split runners build their
Pallas kernels in interpret mode, which is why these cases sit in a file of
their own)."""

import numpy as np
import jax.numpy as jnp
import torch

from raft_tpu.multiraft import autopilot as jap
from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import runner as jrunner
from raft_tpu.multiraft import workload as jwl
from raft_tpu_torch.multiraft import autopilot as tap
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import runner as trunner
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl

from test_torch_runner import (
    CHAOS_DOC, CLIENT_DOC, G, OVERLAY_DOC, RECONFIG_DOC, assert_outputs_equal,
    compiled_both, fresh,
)


def test_reconfig_split_family_g8():
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    jc, tc = compiled_both(jrc, trc, RECONFIG_DOC)
    jov, tov = compiled_both(jchaos, tchaos, OVERLAY_DOC)
    jcfg, jargs, targs = fresh(cfg, RECONFIG_DOC)
    want = jrunner.make_runner(jcfg, (jc, jov), split=True, k=4, window=4,
                               interpret=True)(*jargs)
    legacy = trc.make_split_runner(cfg, tc, tov, k=4, window=4)(*targs)
    runner = trunner.make_runner(cfg, (tc, tov), split=True, k=4, window=4)
    unified = runner(*fresh(cfg, RECONFIG_DOC)[2])
    assert_outputs_equal(legacy, unified, "reconfig split: wrapper against make_runner")
    assert_outputs_equal(want, unified, "reconfig split: port against JAX")
    assert [tuple(s) for s in runner.segments] == [
        tuple(s) for s in jrc.split_plan(jc, 4, jov, 4)
    ]
    assert callable(runner.fused_block) and callable(runner.general_round)


def test_workload_split_family_g8():
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    jc, tc = compiled_both(jwl, twl, CLIENT_DOC)
    jcfg, jargs, targs = fresh(cfg, read=True)
    want = jrunner.make_runner(jcfg, (jc,), split=True, k=4, interpret=True)(*jargs)
    legacy = twl.make_split_runner(cfg, tc, k=4)(*targs)
    runner = trunner.make_runner(cfg, (tc,), split=True, k=4)
    unified = runner(*fresh(cfg, read=True)[2])
    assert_outputs_equal(legacy, unified, "workload split: wrapper against make_runner")
    assert_outputs_equal(want, unified, "workload split: port against JAX")
    assert len(runner.blocks) == jc.n_rounds // 4
    assert callable(runner.fused_block) and callable(runner.steady_block)


def test_cadence_family_g8():
    """One whole-horizon cadence segment with live action planes (one
    transfer target, two kicks): the actions family's golden scenario."""
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True, transfer=True)
    P = cfg.n_peers
    jov, tov = compiled_both(jchaos, tchaos, CHAOS_DOC)
    R = tov.n_rounds
    jc = jap.empty_reconfig_schedule(R, P, G)
    tc = tap.empty_reconfig_schedule(R, P, G, "cpu")
    transfer = np.zeros((G,), np.int32)
    transfer[0] = 2
    kick = np.zeros((P, G), bool)
    kick[0, 1] = True
    kick[1, 2] = True

    def port_args():
        _, _, (st, hl) = fresh(cfg)
        return (st, hl, trc.init_reconfig_state(st), *trc._zero_accumulators("cpu"),
                torch.zeros((), dtype=torch.int32), 0,
                torch.from_numpy(transfer), torch.from_numpy(kick))

    jcfg, (jst, jhl), _ = fresh(cfg)
    want = jrunner.make_runner(jcfg, (jc, jov), cadence=R)(
        jst, jhl, jrc.init_reconfig_state(jst),
        jnp.zeros((jchaos.N_CHAOS_STATS,), jnp.int32),
        jnp.zeros((jrc.N_RECONFIG_STATS,), jnp.int32),
        jnp.zeros((jk.N_SAFETY,), jnp.int32), jnp.int32(0), jnp.int32(0),
        jnp.asarray(transfer), jnp.asarray(kick), *jrunner.schedule_args(jc, jov),
    )
    legacy = tap.make_cadence_runner(cfg, tc, tov, R)(*port_args())
    unified = trunner.make_runner(cfg, (tc, tov), cadence=R)(*port_args())
    assert_outputs_equal(legacy, unified, "cadence: wrapper against make_runner")
    assert_outputs_equal(want, unified, "cadence: port against JAX")
