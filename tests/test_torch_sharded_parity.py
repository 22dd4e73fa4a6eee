"""ClusterSim(mesh=) on two gloo CPU ranks (sharding.launch) against the
JAX package's ClusterSim(mesh=make_mesh(2)) on the 8-device virtual CPU
platform and against the port unsharded, plane by plane and exactly: the
plain run_compiled(24) at G=32, P=3 from the bootstrap; the counter drain
with health planes, the health summary and the black box's capture; and a
random crash schedule through run_round.  Then the chaos and damped
kernels' bodies, built for the host with g++, at a nonzero group_base
against their plain versions, and the plain versions at a base against the
same slice of a whole-batch call.  The ranks run
raft_tpu_torch.tools.sharded_parity_report.replay."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import ClusterSim as JClusterSim
from raft_tpu.multiraft import SimConfig as JSimConfig
from raft_tpu.multiraft import sharding as jsh
from raft_tpu_torch.multiraft import _build, sharding
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft.chaos_kernel import (
    OUTPUT_NAMES as CHAOS_OUTPUTS,
    chaos_rounds,
    chaos_rounds_reference,
)
from raft_tpu_torch.multiraft.damped_kernel import (
    OUTPUT_NAMES as DAMPED_OUTPUTS,
    damped_rounds,
    damped_rounds_reference,
)
from raft_tpu_torch.tools.sharded_parity_report import diff, replay, replay_each

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ is needed to build the host shim"
)

G, P = 32, 3


def crash_schedule(rounds: int, seed: int):
    rng = np.random.RandomState(seed)
    out = []
    for r in range(rounds):
        crashed = rng.rand(P, G) < (0.3 if r % 6 == 0 else 0.05)
        out.append((crashed, (rng.rand(G) < 0.6).astype(np.int32)))
    return out


SPECS = {
    "plain": {"cfg": dict(n_groups=G, n_peers=P),
              "ops": [("run_compiled", 24, np.ones(G, np.int32))]},
    "drain": {"cfg": dict(n_groups=G, n_peers=P, collect_counters=True,
                          collect_health=True, blackbox=True),
              "ops": [("run_compiled", 20, np.ones(G, np.int32)), ("counters",),
                      ("health",), ("forensics",)]},
    "crash": {"cfg": dict(n_groups=G, n_peers=P, collect_health=True),
              "ops": [("run_round", c, a, None) for c, a in crash_schedule(30, 3)]
              + [("health",), ("read_index",)]},
    "step": {"cfg": dict(n_groups=G, n_peers=P),
             "ops": [("sharded_step", 25, np.ones(G, np.int32)), ("sharded_read_index",)]},
    "run_sharded": {"cfg": dict(n_groups=16, n_peers=3), "ops": [("run_sharded", 30)]},
}


@pytest.fixture(scope="module")
def sharded():
    names = list(SPECS)
    outs = sharding.launch(2, replay_each, [SPECS[n] for n in names],
                           devices=["cpu", "cpu"])
    return dict(zip(names, outs))


def jax_state(js) -> dict:
    return {f: np.asarray(getattr(js.state, f)) for f in js.state._fields
            if getattr(js.state, f) is not None}


def assert_equal_to_reference(got: dict, js, tag: str):
    want = jax_state(js)
    assert set(got["state"]) == set(want), tag
    for name, w in want.items():
        np.testing.assert_array_equal(got["state"][name], w, err_msg=f"{tag}:{name}")
    if js._health is not None:
        np.testing.assert_array_equal(got["health"], np.asarray(js._health.planes),
                                      err_msg=f"{tag}:health")


def test_plain_run_compiled_equals_reference_mesh(sharded):
    js = JClusterSim(JSimConfig(n_groups=G, n_peers=P), mesh=jsh.make_mesh(2))
    js.run_compiled(24, append_n=jnp.ones((G,), jnp.int32))
    assert_equal_to_reference(sharded["plain"], js, "plain")
    assert diff(sharded["plain"], replay(None, SPECS["plain"], "cpu")) == []


def test_drain_counters_health_and_capture_equal_reference_mesh(sharded):
    cfg = JSimConfig(n_groups=G, n_peers=P, collect_counters=True,
                     collect_health=True, blackbox=True)
    js, jl = JClusterSim(cfg, mesh=jsh.make_mesh(2)), JClusterSim(cfg)
    for sim_ in (js, jl):
        sim_.run_compiled(20, append_n=jnp.ones((G,), jnp.int32))
    got = sharded["drain"]
    assert_equal_to_reference(got, js, "drain")
    counters, health, capture = got["results"][1:]
    assert counters == js.counters() == jl.counters()
    # The reference's summary reductions raise on its mesh under this JAX
    # (its health_summary's top_k re-shards onto an empty mesh), so they
    # are held to its unsharded sim, which its own tests hold equal.
    assert health == jl.health()
    assert capture == jl.forensics()
    for f in ("meta", "term", "commit", "trip_round"):
        np.testing.assert_array_equal(got["blackbox"][f], np.asarray(getattr(js._blackbox, f)),
                                      err_msg=f)
    assert diff(got, replay(None, SPECS["drain"], "cpu")) == []


def test_random_crash_schedule_through_run_round_equals_reference_mesh(sharded):
    cfg = JSimConfig(n_groups=G, n_peers=P, collect_health=True)
    js, jl = JClusterSim(cfg, mesh=jsh.make_mesh(2)), JClusterSim(cfg)
    for crashed, append in crash_schedule(30, 3):
        for sim_ in (js, jl):
            sim_.run_round(jnp.asarray(crashed), jnp.asarray(append))
    got = sharded["crash"]
    assert_equal_to_reference(got, js, "crash")
    assert got["results"][-2] == jl.health()
    assert got["results"][-1] == np.asarray(js.read_index()).tolist()
    assert diff(got, replay(None, SPECS["crash"], "cpu")) == []


# --- the kernels at a nonzero group base -------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def chaos_operands(Pn, Gn, seed):
    rng = np.random.default_rng(seed)

    def ints(hi, shape=(Pn, Gn)):
        return _t(rng.integers(0, hi, size=shape).astype(np.int32))

    def bools(p):
        return _t(rng.random((Pn, Gn)) < p)

    loss = rng.integers(0, tk.LOSS_SCALE + 1, size=(Pn, Pn, Gn))
    loss = _t(np.where(rng.random((Pn, Pn, Gn)) < 0.5, loss // 20, loss).astype(np.int32))
    return [ints(3), ints(Pn + 1), ints(3), ints(12), ints(40), ints(5), ints(40),
            ints(40), bools(0.8), bools(0.9), bools(0.2), ints(40, (Pn, Pn, Gn)), loss,
            ints(40, (Gn,)), ints(5, (Gn,)), ints(3, (Gn,))]


def damped_operands(Pn, Gn, seed):
    c = chaos_operands(Pn, Gn, seed)
    rng = np.random.default_rng(seed + 1)
    ra = _t(rng.random((Pn, Gn)) < 0.5)
    return c[:8] + [ra] + c[8:]


def _slice(args, lo, hi):
    return [None if a is None else a[..., lo:hi].contiguous() for a in args]


def host_chaos(args, base, **kw):
    lib = _build.load_chaos_host()
    Pn, Gn = args[0].shape
    outs = [torch.empty((Pn, Gn), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((Pn, Pn, Gn), dtype=torch.int32))
    rc = lib.chaos_round_host_at(
        *[t.data_ptr() for t in (*args, *outs)], None, None, Gn, Pn,
        kw["round_base"], kw["rounds"], kw["election_tick"], kw["heartbeat_tick"], 0, base,
    )
    assert rc == 0
    return outs


def host_damped(args, base, **kw):
    lib = _build.load_damped_host()
    Pn, Gn = args[0].shape
    outs = [torch.empty((Pn, Gn), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((Pn, Gn), dtype=torch.bool))
    outs.append(torch.empty((Pn, Pn, Gn), dtype=torch.int32))
    rc = lib.damped_round_host_at(
        *[t.data_ptr() for t in (*args, *outs)], None, None, Gn, Pn,
        kw["round_base"], kw["rounds"], kw["election_tick"], kw["heartbeat_tick"],
        int(kw["with_cq"]), 1, 0, base,
    )
    assert rc == 0
    return outs


@needs_gxx
@pytest.mark.parametrize("kind", ["chaos", "damped"])
@pytest.mark.parametrize("base", [50_000, 8_300_000])
def test_host_kernels_at_group_base_equal_plain(kind, base):
    """Each body at group_base > 0 equals its plain version at that base,
    and the plain version at a base equals the same slice of a whole-batch
    call from 0 (so the loss draw keys on the global id); at another base
    the lossy outputs differ."""
    Gn, Pn, lo = 37, 5, 16
    if kind == "chaos":
        args, names = chaos_operands(Pn, Gn, base % 97), CHAOS_OUTPUTS
        kw = dict(round_base=150, rounds=8, election_tick=10, heartbeat_tick=1)
        plain, host = chaos_rounds_reference, host_chaos
    else:
        args, names = damped_operands(Pn, Gn, base % 89), DAMPED_OUTPUTS
        kw = dict(round_base=150, rounds=8, election_tick=10, heartbeat_tick=1,
                  with_cq=True)
        plain, host = damped_rounds_reference, host_damped
    want = plain(*args, **kw, group_base=base)
    for name, w, g in zip(names, want, host(args, base, **kw)):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{kind}:{name}")
    whole = plain(*args, **kw, group_base=base - lo)
    part = plain(*_slice(args, lo, Gn), **kw, group_base=base)
    for name, w, g in zip(names, whole, part):
        np.testing.assert_array_equal(g.numpy(), w[..., lo:].numpy(), err_msg=f"{kind}:{name}")
    other = plain(*_slice(args, lo, Gn), **kw, group_base=base + 1)
    assert any(not torch.equal(a, b) for a, b in zip(part, other))


def test_wrappers_refuse_a_negative_group_base():
    args = chaos_operands(3, 8, 1)
    kw = dict(round_base=0, rounds=1, election_tick=10, heartbeat_tick=1)
    with pytest.raises(ValueError):
        chaos_rounds(*args, **kw, group_base=-1)
    with pytest.raises(ValueError):
        damped_rounds(*damped_operands(3, 8, 1), **kw, with_cq=True, group_base=-1)


def test_sharded_step_and_read_index_equal_reference(sharded):
    """sharding.sharded_step for 25 rounds and sharding.sharded_read_index
    at G=32, P=3 against the reference's jitted step and read_index (its
    test_sharding.py cases), every group serving reads."""
    from raft_tpu.multiraft import sim as jsim

    cfg = JSimConfig(n_groups=G, n_peers=P)
    js = JClusterSim(cfg)
    crashed = jnp.zeros((P, G), bool)
    js.run(25, crashed, jnp.ones((G,), jnp.int32))
    st = js.state
    got = sharded["step"]
    for name in st._fields:
        if getattr(st, name) is not None:
            np.testing.assert_array_equal(got["state"][name], np.asarray(getattr(st, name)),
                                          err_msg=name)
    want = np.asarray(jsim.read_index(cfg, st, crashed)).tolist()
    assert got["results"][1] == want and min(want) >= 0


def test_run_sharded_equals_reference(sharded):
    """run_sharded's state and status against the reference's over its
    2-device mesh (its test_global_status_collectives)."""
    jst, jstatus = jsh.run_sharded(JSimConfig(n_groups=16, n_peers=3), jsh.make_mesh(2),
                                   rounds=30)
    got = sharded["run_sharded"]
    for name in jst._fields:
        if getattr(jst, name) is not None:
            np.testing.assert_array_equal(got["state"][name], np.asarray(getattr(jst, name)),
                                          err_msg=name)
    assert got["results"][0] == {k: int(v) for k, v in jstatus.items()}
    assert got["results"][0]["n_leaders"] == 16
