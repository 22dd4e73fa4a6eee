"""The compiled scan (ClusterSim.run_compiled) and its carry on the CPU,
against the port's own loop and against the JAX package, exactly:

  * sim.pack_ra_carry / unpack_ra_carry round-trip recent_active at G=33
    (one full word and a ragged one), pass an undamped state through, and
    give the reference's uint32 words;
  * run_compiled equals run with counters, health, the black box and a
    HealthMonitor, with the drain cadence and a residual window from
    run_round included;
  * the port's run_compiled equals the reference's at G=16, plain and damped,
    the monitor's summary stream and the counter totals included, and with
    a link plane (the reference's own schedule: a one-way cut, health on,
    12 rounds) equals 12 run_round(link=) calls and the reference's;
  * the device-scalar forms of window_pos (kernels.update_health) and
    round_idx (kernels.blackbox_fold), which the CUDA graph carries, give
    the planes of the int forms;
  * the plain round's election phase as the CUDA graph runs it (graphs.cond:
    the false branch's values, overwritten by the true branch where any
    peer campaigns) equals the host-branch round, and the spmd arm, over a
    seeded storm.

These last two are the CPU's hold on what the graph runs; the graph itself
runs only on a card (chip_smoke.py's `compiled` phase).  Kernel functions
of the JAX package are looked up by name (getattr), so its
parity-obligation baseline stays as it is."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import graphs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_sim import assert_states_equal


def kfn(mod, name):
    """A kernel function looked up by name (see the module docstring)."""
    return getattr(mod, name)


def assert_sims_equal(a, b, note):
    """Two port ClusterSims: state, counters, health, black box."""
    for f in tsim.SimState._fields:
        x, y = getattr(a.state, f), getattr(b.state, f)
        assert (x is None) == (y is None), (note, f)
        if x is not None:
            assert torch.equal(x, y), f"{note}: {f}"
    if a._counters is not None:
        assert a._host_counters == b._host_counters, note
        assert torch.equal(a._counters, b._counters), note
    if a._health is not None:
        assert torch.equal(a._health.planes, b._health.planes), note
        assert a._health.window_pos == b._health.window_pos, note
    if a._blackbox is not None:
        for x, y in zip(a._blackbox[:4], b._blackbox[:4]):
            assert torch.equal(x, y), note
        assert a._blackbox.round_idx == b._blackbox.round_idx, note
    assert a._rounds_since_drain == b._rounds_since_drain, note


def summaries(mon):
    return [e["summary"] for e in mon.summary_ring()]


# --- the packed carry --------------------------------------------------------


def test_pack_ra_carry_round_trip_g33_and_reference_words():
    cfg = tsim.SimConfig(n_groups=33, n_peers=3, check_quorum=True, pre_vote=True)
    rng = np.random.RandomState(3)
    plane = rng.rand(3, 3, 33) < 0.4
    plane[2, 0, 32] = True
    st = tsim.init_state(cfg, device="cpu")._replace(recent_active=torch.from_numpy(plane))
    stripped, words = tsim.pack_ra_carry(st)
    assert stripped.recent_active is None
    assert words.shape == (3, 3, 2) and words.dtype == torch.int32
    back = tsim.unpack_ra_carry(stripped, words)
    assert torch.equal(back.recent_active, st.recent_active)
    jst = jsim.init_state(jsim.SimConfig(**cfg._asdict()))._replace(
        recent_active=jnp.asarray(plane)
    )
    _, jwords = jsim.pack_ra_carry(jst)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jwords))
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32), np.asarray(kfn(jk, "pack_bits_g")(jnp.asarray(plane)))
    )
    plain = tsim.init_state(tsim.SimConfig(n_groups=4, n_peers=3), device="cpu")
    same, none_words = tsim.pack_ra_carry(plain)
    assert none_words is None and same is plain
    assert tsim.unpack_ra_carry(same, None) is same


# --- run_compiled against run ------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(check_quorum=True, pre_vote=True, blackbox=True),
    dict(collect_counters=True, collect_health=True, blackbox=True),
    dict(collect_health=True, transfer=True, check_quorum=True),
], ids=["plain", "damped-blackbox", "counters-health-blackbox", "health-transfer-damped"])
def test_run_compiled_equals_run(kw):
    """From a state with a residual run_round window, run_compiled equals
    run over the same rounds; with a monitor attached and no counters the
    drains fall on run_round's cadence, so the summary streams match too
    (with counters the segments follow the drain cap, as the reference's)."""
    cfg = tsim.SimConfig(n_groups=33, n_peers=3, election_tick=6, **kw)
    app = torch.ones(33, dtype=torch.int32)
    crashed = torch.zeros((3, 33), dtype=torch.bool)
    crashed[0, ::4] = True
    mons = (HealthMonitor(), HealthMonitor())
    a, b = (tsim.ClusterSim(cfg, health_monitor=m, device="cpu") for m in mons)
    for s in (a, b):
        s.run(5, crashed, app)
    a.run(45, crashed, app)
    b.run_compiled(45, crashed, app)
    if cfg.collect_counters:
        assert a.counters() == b.counters()
    else:
        assert summaries(mons[0]) == summaries(mons[1])
    assert_sims_equal(a, b, str(kw))


def test_run_compiled_residual_window_drains_first():
    """With counters on, a residual run_round window that would pass the
    drain cap with the next segment is drained first, and the totals stay
    those of the loop."""
    cfg = tsim.SimConfig(n_groups=16, n_peers=3, collect_counters=True,
                         collect_health=True)
    app = torch.ones(16, dtype=torch.int32)
    a, b = (tsim.ClusterSim(cfg, device="cpu") for _ in range(2))
    for s in (a, b):
        s.run(5, None, app)
        s._drain_cap = 8  # a small cap so a 12-round call splits
    assert b._rounds_since_drain > 0
    a.run(12, None, app)
    b.run_compiled(12, append_n=app)
    assert a.counters() == b.counters()
    assert_sims_equal(a, b, "residual window")


# --- against the reference ---------------------------------------------------


@pytest.mark.parametrize("damped", [False, True], ids=["plain", "damped"])
def test_run_compiled_equals_jax(damped):
    kw = dict(check_quorum=True, pre_vote=True) if damped else {}
    cfg = tsim.SimConfig(n_groups=16, n_peers=3, collect_counters=True,
                         collect_health=True, **kw)
    jcfg = jsim.SimConfig(**cfg._asdict())
    jm, tm = JMonitor(), HealthMonitor()
    j = jsim.ClusterSim(jcfg, health_monitor=jm)
    t = tsim.ClusterSim(cfg, health_monitor=tm, device="cpu")
    japp = jnp.ones((16,), jnp.int32)
    tapp = torch.ones(16, dtype=torch.int32)
    for _ in range(3):
        j.run_round(None, japp)
        t.run_round(None, tapp)
    j.run_compiled(21, append_n=japp)
    t.run_compiled(21, append_n=tapp)
    assert_states_equal(j.state, t.state, "run_compiled")
    assert t.counters() == j.counters()
    np.testing.assert_array_equal(t._health.planes.numpy(), np.asarray(j._health.planes))
    assert t._health.window_pos == int(j._health.window_pos)
    assert summaries(tm) == summaries(jm)


def test_run_compiled_link_equals_rounds_and_jax():
    """The reference's schedule for run_compiled with a link plane
    (tests/test_chaos_parity.py::test_run_compiled_matches_stepping): a
    one-way 0 -> 1 cut in even groups, health on, 12 rounds from
    init_state; the port's run_compiled(12, link=) equals 12
    run_round(link=) calls and raft_tpu's run_compiled, on every state
    field and the health planes."""
    n, p = 8, 3
    cfg = tsim.SimConfig(n_groups=n, n_peers=p, collect_health=True, health_window=8)
    link_np = np.ones((p, p, n), bool)
    link_np[0, 1, ::2] = False
    link = torch.from_numpy(link_np)
    app = torch.ones(n, dtype=torch.int32)
    loop, graph = (tsim.ClusterSim(cfg, device="cpu") for _ in range(2))
    for _ in range(12):
        loop.run_round(append_n=app, link=link)
    graph.run_compiled(12, append_n=app, link=link)
    assert_sims_equal(loop, graph, "run_compiled(link=) against run_round(link=)")
    j = jsim.ClusterSim(jsim.SimConfig(**cfg._asdict()))
    j.run_compiled(12, append_n=jnp.ones((n,), jnp.int32), link=jnp.asarray(link_np))
    assert_states_equal(j.state, graph.state, "run_compiled(link=) against raft_tpu")
    np.testing.assert_array_equal(graph._health.planes.numpy(), np.asarray(j._health.planes))
    assert graph._health.window_pos == int(j._health.window_pos)


# --- what the graph runs -----------------------------------------------------


def test_device_scalar_forms_equal_int_forms():
    """update_health and blackbox_fold with window_pos / round_idx as 0-d
    int32 tensors, as the CUDA graph carries them, over windows and ring
    wraps: the same planes, and the scalar advanced as the int."""
    rng = np.random.RandomState(5)
    G, W, window = 12, 4, 5
    planes_i = planes_t = torch.from_numpy(rng.randint(0, 9, (tk.N_HEALTH_PLANES, G)).astype(np.int32))
    pos_i, pos_t = 3, torch.tensor(3, dtype=torch.int32)
    meta, term, commit, trip, ri = kfn(tk, "zero_blackbox")(G, W, "cpu")
    bb_i = (meta, term, commit, trip, 0)
    bb_t = (meta, term, commit, trip, torch.tensor(0, dtype=torch.int32))
    for r in range(11):
        has_l = torch.from_numpy(rng.rand(G) < 0.5)
        adv = torch.from_numpy(rng.rand(G) < 0.5)
        bump = torch.from_numpy(rng.randint(0, 2, G).astype(np.int32))
        split = torch.from_numpy(rng.rand(G) < 0.3)
        planes_i, pos_i = kfn(tk, "update_health")(planes_i, pos_i, window, has_l, adv, bump, split)
        planes_t, pos_t = kfn(tk, "update_health")(planes_t, pos_t, window, has_l, adv, bump, split)
        assert torch.equal(planes_i, planes_t) and int(pos_t) == pos_i
        assert pos_t.dtype == torch.int32 and pos_t.dim() == 0
        state = torch.from_numpy(rng.randint(0, 4, (3, G)).astype(np.int32))
        tterm = torch.from_numpy(rng.randint(0, 50, (3, G)).astype(np.int32))
        tcommit = torch.from_numpy(rng.randint(0, 50, (3, G)).astype(np.int32))
        crashed = torch.from_numpy(rng.rand(3, G) < 0.2)
        viol = torch.from_numpy(rng.rand(tk.N_SAFETY, G) < 0.1)
        bb_i = kfn(tk, "blackbox_fold")(*bb_i, state, tterm, tcommit, crashed, viol)
        bb_t = kfn(tk, "blackbox_fold")(*bb_t, state, tterm, tcommit, crashed, viol)
        for x, y in zip(bb_i[:4], bb_t[:4]):
            assert torch.equal(x, y), r
        assert int(bb_t[4]) == bb_i[4] and bb_t[4].dtype == torch.int32


def test_graph_election_branch_equals_host_branch(monkeypatch):
    """The plain round with graphs.cond evaluated as the graph does it
    (both branches run, the false branch's values first, the true branch's
    taken where pred holds) equals the host-branch round and the spmd arm,
    round by round over a seeded storm of crashes (elections in some rounds,
    none in others)."""
    real = graphs.cond
    taken = []

    def as_the_graph(pred, true_fn, false_fn, operands):
        before = [t.clone() for t in operands]
        default = tuple(false_fn(*operands))
        outs = tuple(true_fn(*operands))
        for x, y in zip(before, operands):
            assert torch.equal(x, y), "a branch wrote to its operands"
        taken.append(bool(pred))
        return tuple(torch.where(pred, o, d) for o, d in zip(outs, default))

    cfg = tsim.SimConfig(n_groups=24, n_peers=5, election_tick=4)
    rng = np.random.RandomState(11)
    st = tsim.init_state(cfg, device="cpu")
    app = torch.ones(24, dtype=torch.int32)
    for r in range(40):
        crashed = torch.from_numpy(rng.rand(5, 24) < (0.3 if r % 10 < 3 else 0.0))
        want = tsim.step(cfg, st, crashed, app)
        spmd = tsim.step(cfg._replace(spmd=True), st, crashed, app)
        monkeypatch.setattr(graphs, "cond", as_the_graph)
        got = tsim.step(cfg, st, crashed, app)
        monkeypatch.setattr(graphs, "cond", real)
        for f in tsim.SimState._fields:
            x, y, z = getattr(want, f), getattr(got, f), getattr(spmd, f)
            if x is not None:
                assert torch.equal(x, y) and torch.equal(x, z), (r, f)
        st = want
    assert any(taken) and not all(taken)


def test_cond_is_a_host_branch_off_the_graph():
    pred_t, pred_f = torch.tensor(True), torch.tensor(False)
    x = torch.arange(4)
    t = graphs.cond(pred_t, lambda a: (a + 1,), lambda a: (a - 1,), (x,))
    f = graphs.cond(pred_f, lambda a: (a + 1,), lambda a: (a - 1,), (x,))
    assert torch.equal(t[0], x + 1) and torch.equal(f[0], x - 1)


def test_new_entry_points_default_to_cuda(tmp_path):
    """run_compiled's sim, the checkpoint loaders and the unified runner's
    schedules allocate on `cuda` unless told otherwise, and raise rather
    than fall back where there is no card."""
    from raft_tpu_torch.multiraft import chaos, checkpoint, runner

    cfg = tsim.SimConfig(n_groups=4, n_peers=3, collect_health=True, blackbox=True)
    s = tsim.ClusterSim(cfg, device="cpu")
    paths = {"state": str(tmp_path / "s.npz"), "blackbox": str(tmp_path / "b.npz")}
    checkpoint.save_state(s.state, paths["state"])
    checkpoint.save_blackbox_state(s._blackbox, paths["blackbox"])
    plan = chaos.plan_from_dict({"name": "x", "peers": 3, "phases": [{"rounds": 2}]})
    if torch.cuda.is_available():
        c = tsim.ClusterSim(cfg)
        c.run_compiled(2)
        assert c.state.term.is_cuda and c._blackbox.meta.is_cuda
        assert checkpoint.load_state(paths["state"]).term.is_cuda
        assert checkpoint.load_blackbox_state(paths["blackbox"]).meta.is_cuda
        out = runner.make_runner(cfg, (chaos.compile_plan(plan, 4),))(
            c.state, c._health, c._blackbox)
        assert out[0].term.is_cuda
    else:
        for call in (lambda: tsim.ClusterSim(cfg).run_compiled(2),
                     lambda: checkpoint.load_state(paths["state"]),
                     lambda: checkpoint.load_blackbox_state(paths["blackbox"]),
                     lambda: runner.make_runner(cfg, (chaos.compile_plan(plan, 4),))):
            with pytest.raises(RuntimeError):
                call()
