"""The port's client workloads against the JAX package on the CPU, exactly
(every plane is int32 or bool):

  * `workload.compile_plan` and `HostClientSchedule` give the reference's
    arrays, the seeded Zipf draws and the packed fire words included, for
    tests/test_workload.py's mixed plan and examples/reads/zipf_mixed.json;
    `plan_from_dict` and the plan checks as the reference's;
  * `latency_percentiles` against the reference's and against
    `host_latency_percentile`, the nearest-rank rule;
  * `reads_pending_in_horizon`, `lease_fires_in_block` and
    `fused_step.steady_mask(read_pending=)`;
  * `workload.make_runner` against the reference's from init_state on all
    nine outputs: undamped, check-quorum, composed with a chaos plan, and
    composed with a chaos and a reconfig plan;
  * `read_report` and `HealthMonitor.record_reads`.

Kernel functions are looked up by name (getattr), so the JAX package's
parity-obligation baseline stays as it is."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft import workload as jwl
from raft_tpu.multiraft.health import HealthMonitor as JMonitor
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import reconfig as trc
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl
from raft_tpu_torch.multiraft.health import HealthMonitor

from test_torch_reconfig import PLANS, assert_run_equal, kfn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZIPF_MIXED = os.path.join(ROOT, "examples", "reads", "zipf_mixed.json")


def mixed_doc(n_peers, rounds, seed=5, settle=16):
    """tests/test_workload.py's mixed_read_plan as a plan document: a
    settle, lease reads with Zipf writes, then Safe reads every round."""
    body = rounds - settle
    a = body // 2
    return {"name": "mixed", "peers": n_peers, "seed": seed, "phases": [
        {"rounds": settle, "append": 1},
        {"rounds": a, "write_zipf": 1.9, "write_max": 4, "read_every": 2,
         "read_mode": "lease"},
        {"rounds": body - a, "append": 1, "read_every": 1, "read_mode": "safe"}]}


def zipf_doc():
    with open(ZIPF_MIXED, encoding="utf-8") as f:
        return json.load(f)


def both_plans(doc):
    return jwl.plan_from_dict(doc), twl.plan_from_dict(doc)


def assert_compiled_equal(jc, tc):
    assert tc.n_rounds == jc.n_rounds and tc.n_peers == jc.n_peers
    assert tc.phase_of_round.device.type == "cpu"
    for f in ("phase_of_round", "read_mode", "append"):
        g, w = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert tc.read_fire_packed.dtype == torch.int32
    np.testing.assert_array_equal(tc.read_fire_packed.numpy().view(np.uint32),
                                  np.asarray(jc.read_fire_packed))


# --- the host-side schedule ---------------------------------------------------


@pytest.mark.parametrize("case", ["mixed_g11", "zipf_mixed_g16", "zipf_mixed_g100"])
def test_compiled_client_matches_jax(case):
    doc, G = {"mixed_g11": (mixed_doc(3, 48), 11), "zipf_mixed_g16": (zipf_doc(), 16),
              "zipf_mixed_g100": (zipf_doc(), 100)}[case]
    jp, tp = both_plans(doc)
    tc = twl.compile_plan(tp, G, "cpu")
    assert_compiled_equal(jwl.compile_plan(jp, G), tc)
    jh, th = jwl.HostClientSchedule(jp, G), twl.HostClientSchedule(tp, G)
    for f in ("phase_of_round", "read_fire", "read_mode", "append"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), err_msg=f)
    for r in range(0, th.n_rounds, 7):
        for g, w in zip(th.masks(r), jh.masks(r)):
            np.testing.assert_array_equal(g, w)
    fire = kfn(tk, "unpack_bits_g")(tc.read_fire_packed, G)
    np.testing.assert_array_equal(fire.numpy(), th.read_fire)
    # The Zipf draws are seeded: a recompile reproduces them, a new seed
    # moves them.
    assert torch.equal(twl.compile_plan(tp, G, "cpu").append, tc.append)
    other = twl.compile_plan(twl.plan_from_dict(dict(doc, seed=doc["seed"] + 1)), G, "cpu")
    assert not torch.equal(other.append, tc.append)


def test_plan_json_round_trip():
    doc = {"name": "zm", "peers": 5, "seed": 7, "phases": [
        {"rounds": 8, "append": 1},
        {"rounds": 8, "write_zipf": 1.8, "read_every": 2, "read_mode": "lease",
         "groups": {"mod": 2, "eq": 1}},
        {"rounds": 4, "read_every": 3, "stagger": False, "groups": [0, 3]}]}
    jp, tp = both_plans(doc)
    assert tp.n_rounds == jp.n_rounds == 20 and tp.phases[1].read_mode == "lease"
    assert (tp.name, tp.n_peers, tp.seed) == (jp.name, jp.n_peers, jp.seed)
    assert [vars(p) for p in tp.phases] == [vars(p) for p in jp.phases]
    c = twl.compile_plan(tp, 6, "cpu")
    assert set(np.unique(c.read_mode[1].numpy())) == {0, tsim.READ_LEASE}
    assert_compiled_equal(jwl.compile_plan(jp, 6), c)


@pytest.mark.parametrize("bad", [
    {"peers": 3, "phases": [{"rounds": 4, "read_mode": "stale"}]},
    {"peers": 3, "phases": ["four"]},
    {"peers": 3, "phases": []},
    {"peers": 3, "phases": [{"rounds": 0}]},
    {"peers": 3, "phases": [{"rounds": 4, "write_zipf": 1.0}]},
    {"peers": 3, "phases": [{"rounds": 4, "groups": [9]}]},
], ids=["mode", "not_object", "no_phases", "zero_rounds", "zipf_one", "group_range"])
def test_bad_plans_raise_as_in_jax(bad):
    with pytest.raises(ValueError) as want:
        jwl.compile_plan(jwl.plan_from_dict(bad), 4)
    with pytest.raises(ValueError) as got:
        twl.compile_plan(twl.plan_from_dict(bad), 4, "cpu")
    assert str(got.value) == str(want.value)


def test_oversized_plan_raises_as_in_jax():
    doc = {"peers": 3, "phases": [{"rounds": 2**21}]}
    msgs = []
    for mod in (jwl, twl):
        with pytest.raises(ValueError) as err:
            mod._compile_arrays(mod.plan_from_dict(doc), 1024)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --- the latency percentiles --------------------------------------------------


def test_latency_percentiles_match_jax_and_nearest_rank():
    rng = np.random.RandomState(0)
    for _ in range(16):
        n = rng.randint(0, 200)
        samples = rng.randint(0, twl.N_LAT_BUCKETS + 8, size=n)  # past the cap too
        clipped = np.minimum(samples, twl.LAT_CAP)
        hist = np.bincount(clipped, minlength=twl.N_LAT_BUCKETS).astype(np.int32)
        got = twl.latency_percentiles(torch.from_numpy(hist))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jwl.latency_percentiles(jnp.asarray(hist))))
        for i, q in enumerate((50, 90, 99)):
            want = twl.host_latency_percentile(clipped, q)
            assert want == jwl.host_latency_percentile(clipped, q)
            assert int(got[i]) == want, (n, q)
    empty = torch.zeros(twl.N_LAT_BUCKETS, dtype=torch.int32)
    assert (twl.latency_percentiles(empty) == -1).all()
    # About the served count of zipf_mixed.json at 100k groups: a naive n*q
    # would wrap int32.
    big = np.zeros(twl.N_LAT_BUCKETS, np.int32)
    big[:4] = (9_000_000, 700_000, 150_000, 50_001)
    got = twl.latency_percentiles(torch.from_numpy(big), (1, 50, 90, 99, 100))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jwl.latency_percentiles(jnp.asarray(big), (1, 50, 90, 99, 100))))
    assert got.tolist() == [0, 0, 0, 2, 3]


# --- the fused horizon's read masks ---------------------------------------------


def test_reads_pending_and_lease_fires_match_jax():
    """Every block start of zipf_mixed.json at G=16, k in (4, 8), past the
    plan's end too, with an idle and a random outstanding-read carry."""
    G = 16
    jp, tp = both_plans(zipf_doc())
    jc, tc = jwl.compile_plan(jp, G), twl.compile_plan(tp, G, "cpu")
    rng = np.random.default_rng(3)
    carries = [np.zeros(G, np.int32), rng.integers(0, 3, G).astype(np.int32)]
    seen = set()
    for pend in carries:
        jcar = jwl.ReadCarry(jnp.asarray(pend), jnp.zeros((G,), jnp.int32))
        tcar = twl.ReadCarry(torch.from_numpy(pend), torch.zeros(G, dtype=torch.int32))
        for k in (4, 8):
            for r0 in list(range(0, tc.n_rounds, k)) + [tc.n_rounds - 2]:
                want = np.asarray(jwl.reads_pending_in_horizon(jc, jcar, jnp.int32(r0), k))
                got = twl.reads_pending_in_horizon(tc, tcar, r0, k)
                assert got.dtype == torch.bool
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"r0={r0} k={k}")
                jn, ja = jwl.lease_fires_in_block(jc, jnp.int32(r0), k)
                tn, ta = twl.lease_fires_in_block(tc, r0, k)
                assert tn.dtype == torch.int32
                np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
                np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
                seen.add((bool(want.any()), bool(np.asarray(ja).any())))
    assert seen == {(False, False), (False, True), (True, False), (True, True)}


def test_steady_mask_read_pending_matches_jax():
    """A settled check-quorum batch accepts the horizon; with read_pending
    it rejects exactly the flagged groups, as the reference's mask."""
    G, P = 8, 3
    kw = dict(n_groups=G, n_peers=P, election_tick=16, collect_health=True,
              check_quorum=True, lease_read=True)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    st = tsim.init_state(tcfg, device="cpu")
    for _ in range(48):
        st = tsim.step(tcfg, st, torch.zeros((P, G), dtype=torch.bool),
                       torch.ones(G, dtype=torch.int32))
    jst = jsim.SimState(**{f: None if v is None else jnp.asarray(v.numpy())
                           for f, v in st._asdict().items()})
    crashed = torch.zeros((P, G), dtype=torch.bool)
    base = tfs.steady_mask(tcfg, st, crashed, horizon=4)
    assert base.all(), "settled batch must be steady"
    for pend in (np.tile([True, False], 4), np.zeros(G, bool), np.ones(G, bool)):
        want = np.asarray(jps.steady_mask(jcfg, jst, jnp.asarray(crashed.numpy()),
                                          horizon=4, read_pending=jnp.asarray(pend)))
        got = tfs.steady_mask(tcfg, st, crashed, horizon=4,
                              read_pending=torch.from_numpy(pend))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ~pend)


# --- the whole-plan runner ----------------------------------------------------


READ_NAMES = ("read_carry", "read_stats", "lat_hist")


def assert_workload_equal(want, got, note):
    """make_runner's nine outputs of both packages."""
    assert_run_equal(want, got, note)
    for f in twl.ReadCarry._fields:
        g, w = getattr(got[6], f), np.asarray(getattr(want[6], f))
        assert g.dtype == torch.int32, (note, f)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{note}: read carry {f}")
    for i, name in ((7, "read_stats"), (8, "lat_hist")):
        assert got[i].dtype == torch.int32, (note, name)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=f"{note}: {name}")


WL_CHAOS = {"name": "wl-chaos", "peers": 3, "phases": [
    {"rounds": 16, "append": 1},
    {"rounds": 24, "partition": [[1], [2, 3]], "loss_all": 0.05, "append": 1},
    {"rounds": 16, "append": 1}]}


def runner_case(case):
    """(config kwargs, client plan doc, chaos doc, reconfig doc, G)."""
    if case == "undamped":
        return dict(), mixed_doc(3, 56), None, None, 6
    if case == "check_quorum":
        return dict(check_quorum=True, lease_read=True), mixed_doc(3, 56), None, None, 6
    if case == "chaos_cq_pv":
        return (dict(check_quorum=True, pre_vote=True, lease_read=True),
                mixed_doc(3, 56), WL_CHAOS, None, 4)
    doc = PLANS["promote_learner_lossy"]
    n = sum(ph["rounds"] for ph in doc["reconfig"]["phases"])
    overlay = {"name": "overlay", "peers": 3, "phases": [
        {"rounds": n, "read_every": 1, "read_mode": "lease"}]}
    return (dict(check_quorum=True, lease_read=True), overlay, doc["chaos"],
            doc["reconfig"], 8)


@pytest.mark.parametrize("case", ["undamped", "check_quorum", "chaos_cq_pv",
                                  "reconfig_chaos_cq"])
def test_make_runner_matches_jax(case):
    kw, cdoc, chdoc, rdoc, G = runner_case(case)
    kw = dict(n_groups=G, n_peers=3, collect_health=True, **kw)
    jcfg, tcfg = jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    jp, tp = both_plans(cdoc)
    jcc = tcc = jrcc = trcc = None
    if chdoc is not None:
        jcc = jchaos.compile_plan(jchaos.plan_from_dict(chdoc), G)
        tcc = tchaos.compile_plan(tchaos.plan_from_dict(chdoc), G, "cpu")
    jmasks = tmasks = ()
    if rdoc is not None:
        jrp, trp = jrc.plan_from_dict(rdoc), trc.plan_from_dict(rdoc)
        jrcc, trcc = jrc.compile_plan(jrp, G), trc.compile_plan(trp, G, "cpu")
        jmasks, tmasks = jrc.initial_masks(jrp, G), trc.initial_masks(trp, G, "cpu")
    jst, tst = jsim.init_state(jcfg, *jmasks), tsim.init_state(tcfg, *tmasks, device="cpu")
    want = jwl.make_runner(jcfg, jwl.compile_plan(jp, G), jcc, jrcc)(
        jst, jsim.init_health(jcfg), jrc.init_reconfig_state(jst), jwl.init_read_carry(G))
    got = twl.make_runner(tcfg, twl.compile_plan(tp, G, "cpu"), tcc, trcc)(
        tst, tsim.init_health(tcfg, "cpu"), trc.init_reconfig_state(tst),
        twl.init_read_carry(G, "cpu"))
    assert_workload_equal(want, got, case)
    rd = got[7]
    assert rd[twl.RS_ISSUED] > 0 and rd[twl.RS_SERVED_QUORUM] > 0
    assert (rd[twl.RS_SERVED_LEASE] > 0) == (case != "undamped")
    if case == "undamped":
        assert rd[twl.RS_DEGRADED_SERVES] > 0
    if case == "chaos_cq_pv":
        assert rd[twl.RS_RETRY_ROUNDS] > 0
    if rdoc is not None:
        assert got[4][trc.RC_APPLIED] > 0
    assert not got[5].any(), got[5]


def test_runner_checks_as_jax():
    G = 4
    cfg = tsim.SimConfig(n_groups=G, n_peers=3, collect_health=True)
    tp = twl.plan_from_dict(mixed_doc(3, 24))
    tc = twl.compile_plan(tp, G, "cpu")
    with pytest.raises(ValueError, match="peers"):
        twl.make_runner(cfg._replace(n_peers=5), tc)
    with pytest.raises(ValueError, match="groups"):
        twl.make_runner(cfg._replace(n_groups=5), tc)
    short = tchaos.compile_plan(tchaos.plan_from_dict(
        {"peers": 3, "phases": [{"rounds": 5}]}), G, "cpu")
    with pytest.raises(ValueError, match="equal-length"):
        twl.make_runner(cfg, tc, short)
    st0 = tsim.init_state(cfg, device="cpu")
    with pytest.raises(TypeError, match="BlackboxState"):
        twl.make_runner(cfg._replace(blackbox=True), tc)(
            st0, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st0),
            twl.init_read_carry(G, "cpu"))
    runner = twl.make_runner(cfg, tc)
    st = tsim.init_state(cfg, device="cpu")
    rcar = twl.init_read_carry(G, "cpu")
    with pytest.raises(ValueError):
        runner(st, tsim.init_health(cfg, "cpu"), trc.init_reconfig_state(st),
               rcar._replace(pending_mode=rcar.pending_mode.to("meta")))


# --- the report -------------------------------------------------------------------


class _Metrics:
    def __init__(self):
        self.events = []

    def on_health_summary(self, summary):
        self.events.append(("summary", summary))

    def trace(self, event, **fields):
        self.events.append((event, fields))


@pytest.mark.parametrize("seed", range(3))
def test_read_report_and_record_reads_match_jax(seed):
    rng = np.random.default_rng(seed)
    rdstats = rng.integers(0, 10_000, twl.N_READ_STATS).tolist()
    lat_p = rng.integers(-1, 65, 3).tolist()
    safety = (rng.integers(0, 2, tk.N_SAFETY) * (seed == 2)).tolist()
    stats = rng.integers(0, 500, tchaos.N_CHAOS_STATS).tolist()
    if seed == 1:
        stats[tchaos.CS_REELECTIONS] = 0
    want = jwl.read_report(np.array(rdstats), np.array(lat_p), np.array(safety),
                           np.array(stats), 256)
    got = twl.read_report(rdstats, lat_p, safety, stats, 256)
    assert got == want
    assert list(jk.SAFETY_NAMES) == list(tk.SAFETY_NAMES)
    jm, tm = _Metrics(), _Metrics()
    jmon, tmon = JMonitor(metrics=jm), HealthMonitor(metrics=tm)
    je, te = jmon.record_reads(want), getattr(tmon, "record_reads")(got)
    assert {k: v for k, v in te.items() if k != "ts"} == \
        {k: v for k, v in je.items() if k != "ts"}
    assert tm.events == jm.events
    assert (any(e == "reads.safety" for e, _ in tm.events)) == any(safety)
    assert tmon.last() is te and len(tmon) == 1
