"""The port's unified runner (raft_tpu_torch/multiraft/runner.py) on the
CPU against the JAX package, exactly (every plane is int32 or bool):

  * the chaos, reconfig and workload families of
    tests/test_runner_unified.py at G=8: each legacy entry point
    (chaos.make_runner, reconfig.make_runner, workload.make_runner) equals
    runner.make_runner bit for bit, and both equal
    raft_tpu.multiraft.runner.make_runner on the same plans;
  * the registry plumbing (family_of, flatten, rebuild, schedule_args,
    rebuild_scheds) against the reference's flat order;
  * the dispatch surface's rejections (duplicate and empty schedule sets,
    split and cadence without a reconfig schedule, cadence with a client
    plan);
  * ClusterSim.run_plan, run_reconfig and run_reads reach their runners
    through runner.make_runner.

The split and cadence families, whose JAX runners build Pallas kernels in
interpret mode, are in test_torch_runner_slice.py."""

import numpy as np
import pytest
import torch

from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import runner as jrunner
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft import workload as jwl
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import runner as trunner
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl

G = 8

# The golden scenarios of tests/test_runner_unified.py, as plan documents.
CHAOS_DOC = {
    "name": "unified-chaos", "peers": 3,
    "phases": [
        {"rounds": 16, "append": 1},
        {"rounds": 8, "crash": [1], "append": 1},
        {"rounds": 8, "heal": True, "append": 1},
    ],
}
OVERLAY_DOC = {
    "name": "unified-overlay", "peers": 3,
    "phases": [{"rounds": 32}, {"rounds": 8, "loss_all": 0.03}, {"rounds": 8}],
}
RECONFIG_DOC = {
    "name": "unified-reconfig", "peers": 3, "voters": [1, 2], "learners": [3],
    "phases": [
        {"rounds": 24, "append": 1},
        {"rounds": 8, "append": 1, "op": {"promote_learner": 3}},
        {"rounds": 16, "append": 1},
    ],
}
CLIENT_DOC = {
    "name": "unified-client", "peers": 3, "seed": 7,
    "phases": [
        {"rounds": 16, "append": 1},
        {"rounds": 12, "write_zipf": 1.9, "write_max": 4, "read_every": 2,
         "read_mode": "lease"},
        {"rounds": 12, "append": 1, "read_every": 1, "read_mode": "safe"},
    ],
}


def leaves(out):
    """The output's arrays in order as numpy (None dropped, as a JAX tree
    flatten drops it); Python ints as 0-d arrays."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in leaves(o)]
    if isinstance(out, torch.Tensor):
        return [out.cpu().numpy()]
    return [np.asarray(out)]


def assert_outputs_equal(want, got, note):
    """Leaf by leaf equal; arrays of the same dtype (0-d counts may be a
    Python int on one side)."""
    w, g = leaves(want), leaves(got)
    assert len(w) == len(g), f"{note}: {len(w)} leaves != {len(g)}"
    for i, (a, b) in enumerate(zip(w, g)):
        if a.ndim and b.ndim:
            assert a.dtype == b.dtype, f"{note}: leaf {i} {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(b, a, err_msg=f"{note}: leaf {i}")


def compiled_both(mod_j, mod_t, doc, n_groups=G):
    return (mod_j.compile_plan(mod_j.plan_from_dict(doc), n_groups),
            mod_t.compile_plan(mod_t.plan_from_dict(doc), n_groups, "cpu"))


def fresh(cfg, masks=None, read=False):
    """(JAX config, JAX carry, port carry): fresh state (from the bootstrap
    masks of the reconfig plan document `masks`), health, op-protocol state
    and (with `read`) read carry."""
    jcfg = jsim.SimConfig(**cfg._asdict())
    # Fresh JAX masks each call: the runner donates the state they seed.
    jmasks = (jrc.initial_masks(jrc.plan_from_dict(masks), cfg.n_groups)
              if masks else ())
    tmasks = (trc.initial_masks(trc.plan_from_dict(masks), cfg.n_groups, "cpu")
              if masks else ())
    jst = jsim.init_state(jcfg, *jmasks)
    tst = tsim.init_state(cfg, *tmasks, device="cpu")
    j = (jst, jsim.init_health(jcfg))
    t = (tst, tsim.init_health(cfg, "cpu"))
    if masks is not None or read:
        j, t = j + (jrc.init_reconfig_state(jst),), t + (trc.init_reconfig_state(tst),)
    if read:
        j, t = j + (jwl.init_read_carry(cfg.n_groups),), t + (twl.init_read_carry(cfg.n_groups, "cpu"),)
    return jcfg, j, t


def test_chaos_family_g8():
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    jc, tc = compiled_both(jchaos, tchaos, CHAOS_DOC)
    jcfg, jargs, targs = fresh(cfg)
    want = jrunner.make_runner(jcfg, (jc,))(*jargs)
    legacy = tchaos.make_runner(cfg, tc)(*targs)
    unified = trunner.make_runner(cfg, (tc,))(*fresh(cfg)[2])
    assert_outputs_equal(legacy, unified, "chaos: wrapper against make_runner")
    assert_outputs_equal(want, unified, "chaos: port against JAX")


def test_reconfig_family_g8():
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    jc, tc = compiled_both(jrc, trc, RECONFIG_DOC)
    jov, tov = compiled_both(jchaos, tchaos, OVERLAY_DOC)
    jcfg, jargs, targs = fresh(cfg, RECONFIG_DOC)
    want = jrunner.make_runner(jcfg, (jc, jov))(*jargs)
    legacy = trc.make_runner(cfg, tc, tov)(*targs)
    unified = trunner.make_runner(cfg, (tc, tov))(*fresh(cfg, RECONFIG_DOC)[2])
    assert_outputs_equal(legacy, unified, "reconfig: wrapper against make_runner")
    assert_outputs_equal(want, unified, "reconfig: port against JAX")


def test_workload_family_g8():
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    jc, tc = compiled_both(jwl, twl, CLIENT_DOC)
    jcfg, jargs, targs = fresh(cfg, read=True)
    want = jrunner.make_runner(jcfg, (jc,))(*jargs)
    legacy = twl.make_runner(cfg, tc)(*targs)
    unified = trunner.make_runner(cfg, (tc,))(*fresh(cfg, read=True)[2])
    assert_outputs_equal(legacy, unified, "workload: wrapper against make_runner")
    assert_outputs_equal(want, unified, "workload: port against JAX")


def test_schedule_plumbing_follows_the_registry():
    """family_of classifies; flatten gives the reference's flat order and
    values (packed words compared as uint32 bits); rebuild and
    rebuild_scheds invert it; each runner exposes its schedule_args."""
    jc, tc = compiled_both(jrc, trc, RECONFIG_DOC)
    jov, tov = compiled_both(jchaos, tchaos, OVERLAY_DOC)
    jcl, tcl = compiled_both(jwl, twl, CLIENT_DOC)
    for tsched, fam in ((tc, "reconfig"), (tov, "chaos"), (tcl, "client")):
        assert trunner.family_of(tsched) == fam
        assert trunner.rebuild(fam, tsched, trunner.flatten(fam, tsched)) == tsched
    with pytest.raises(TypeError, match="not a compiled schedule"):
        trunner.family_of(object())
    want = jrunner.schedule_args(jcl, jc, jov)
    got = trunner.schedule_args(tcl, None, tc, tov)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(b, a, err_msg=f"schedule arg {i}")
    sched, chaos_sched = trunner.rebuild_scheds(tc, tov, trunner.schedule_args(tc, tov))
    assert sched == tc and chaos_sched == tov
    assert trunner.rebuild_scheds(tc, None, trunner.schedule_args(tc)) == (tc, None)
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    runner = trunner.make_runner(cfg, (tc, tov))
    assert len(runner.schedule_args) == len(jrunner.schedule_args(jc, jov))


def test_make_runner_rejections():
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, collect_health=True)
    chaos_c = tchaos.compile_plan(tchaos.plan_from_dict(CHAOS_DOC), 4, "cpu")
    client_c = twl.compile_plan(twl.plan_from_dict(CLIENT_DOC), 4, "cpu")
    rc = trc.compile_plan(trc.plan_from_dict(RECONFIG_DOC), 4, "cpu")
    with pytest.raises(ValueError, match="duplicate chaos"):
        trunner.make_runner(cfg, (chaos_c, chaos_c))
    with pytest.raises(ValueError, match="at least one"):
        trunner.make_runner(cfg, ())
    with pytest.raises(ValueError, match="at least one"):
        trunner.make_runner(cfg, (None,))
    with pytest.raises(ValueError, match="reconfig or client"):
        trunner.make_runner(cfg, (chaos_c,), split=True)
    with pytest.raises(ValueError, match="reconfig schedule"):
        trunner.make_runner(cfg, (chaos_c,), cadence=8)
    with pytest.raises(ValueError, match="client plan"):
        trunner.make_runner(cfg._replace(transfer=True), (rc, client_c), cadence=8)


def test_cluster_sim_reaches_runners_through_make_runner(monkeypatch):
    """run_plan, run_reconfig and run_reads build their runners with
    runner.make_runner (and the reports stay those of the runs)."""
    calls = []
    real = trunner.make_runner

    def spy(cfg, schedules=(), **kw):
        calls.append((tuple(trunner.family_of(s) for s in schedules if s is not None),
                      kw.get("split", False)))
        return real(cfg, schedules, **kw)

    monkeypatch.setattr(trunner, "make_runner", spy)
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, collect_health=True)
    tsim.ClusterSim(cfg, chaos=tchaos.plan_from_dict(CHAOS_DOC), device="cpu").run_plan()
    plan = trc.plan_from_dict(RECONFIG_DOC)
    s = tsim.ClusterSim(cfg, *trc.initial_masks(plan, 4, "cpu"), device="cpu")
    s.run_reconfig(plan)
    tsim.ClusterSim(cfg, device="cpu").run_reads(twl.plan_from_dict(CLIENT_DOC))
    assert calls == [(("chaos",), False), (("reconfig",), False), (("client",), False)]
