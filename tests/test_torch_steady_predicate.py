"""The dispatcher's steady predicate kernel (csrc/steady_predicate.cuh),
built for the host with g++ (csrc/steady_predicate_host.cpp), held group by
group to the plain composition it replaces on the card
(`fused_step.steady_mask` and `steady_predicate` on CPU tensors) and to the
JAX package's `pallas_step.steady_mask`: plain, check-quorum, pre-vote and
black-box configs, heartbeat_tick 1 and 2, the degenerate election_tick <=
heartbeat_tick, horizons 1, 8 and 32, P from 1 to 33, with and without
the transferee plane and the reconfig and read rows, on settled states in
which each group breaks one clause of the invariant (or none), and on
random planes with int32 wrap-around; the whole-batch flag as the grid
reduces it, block by block.

The `cuda` test runs on a card (`python3 -m pytest --noconftest -m cuda
tests/test_torch_steady_predicate.py`: the card's machine has no JAX,
which this directory's conftest.py loads, so this file imports JAX only
inside the tests that compare with it): the kernel at 1M groups x 3
peers against the composition, and a profiled fused block's launches."""

import functools

import numpy as np
import pytest
import torch

from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import predicate_kernel as pk
from raft_tpu_torch.multiraft import sim as tsim

LEADER = 2
CONFIGS = {
    "plain-hb1": dict(election_tick=10, heartbeat_tick=1),
    "plain-hb2": dict(election_tick=10, heartbeat_tick=2),
    "cq-pv": dict(election_tick=10, heartbeat_tick=2, check_quorum=True, pre_vote=True),
    "cq": dict(election_tick=10, heartbeat_tick=1, check_quorum=True),
    "pv": dict(election_tick=10, heartbeat_tick=1, pre_vote=True),
}
# Configs that reject every group, on the states of the config named second.
DEGENERATE = {
    "cq-et-le-hb": (dict(election_tick=2, heartbeat_tick=2, check_quorum=True), "cq"),
    "blackbox": (dict(election_tick=10, heartbeat_tick=1, blackbox=True), "plain-hb1"),
}
# One clause of the invariant broken in each group (g % len(KINDS)), or a
# change that keeps it.
KINDS = (
    "steady", "timer_resync_bound", "timer_free_bound", "timer_below",
    "crashed_timer", "two_leaders", "no_leader", "leader_crashed",
    "term_behind", "crashed_term_behind", "joint", "transfer", "row_short",
    "row_one_short", "few_alive", "stale_at_boundary", "stale_before_boundary",
)
G = 2 * len(KINDS)


def config(name, P, n_groups=G, **extra):
    kw = dict(CONFIGS[name]) if name in CONFIGS else dict(DEGENERATE[name][0])
    return tsim.SimConfig(n_groups=n_groups, n_peers=P, **kw, **extra)


@functools.lru_cache(maxsize=None)
def settled(name, P, n_groups=G, rounds=60):
    """A fleet of `name`'s config settled by `rounds` rounds of one append a
    group; every group ends with one leader."""
    s = tsim.ClusterSim(config(name, P, n_groups), device="cpu")
    s.run(rounds, None, torch.ones(n_groups, dtype=torch.int32))
    st = s.state
    assert ((st.state == LEADER).sum(0) == 1).all()
    return st


def crafted(st, cfg, horizon):
    """The settled state with group g broken by KINDS[g % len(KINDS)], a
    transferee plane added, and its crash mask."""
    P, n = st.term.shape
    a = {f: v.clone() for f, v in st._asdict().items() if v is not None}
    a["transferee"] = torch.zeros((P, n), dtype=torch.int32)
    ra = a.get("recent_active")
    crashed = torch.zeros((P, n), dtype=torch.bool)
    lead_of = (a["state"] == LEADER).to(torch.int64).argmax(0)
    et = cfg.election_tick
    for g in range(n):
        kind, lead = KINDS[g % len(KINDS)], int(lead_of[g])
        f = (lead + 1) % P  # a follower (the leader itself where P == 1)
        rt = int(a["randomized_timeout"][f, g])
        if kind == "timer_resync_bound":
            a["election_elapsed"][f, g] = rt - 1
        elif kind == "timer_free_bound":
            a["election_elapsed"][f, g] = rt - horizon
        elif kind == "timer_below":
            a["election_elapsed"][f, g] = rt - horizon - 1
        elif kind == "crashed_timer":
            crashed[f, g] = True
            a["election_elapsed"][f, g] = rt - horizon
        elif kind == "two_leaders":
            a["state"][f, g] = LEADER
        elif kind == "no_leader":
            a["state"][lead, g] = 0
        elif kind == "leader_crashed":
            crashed[lead, g] = True
        elif kind == "term_behind":
            a["term"][f, g] -= 1
        elif kind == "crashed_term_behind":
            a["term"][f, g] -= 1
            crashed[f, g] = True
        elif kind == "joint":
            a["outgoing_mask"][f, g] = True
        elif kind == "transfer":
            a["transferee"][lead, g] = f + 1
        elif kind == "row_short" and ra is not None:
            ra[lead, :, g] = False
        elif kind == "row_one_short" and ra is not None:
            ra[lead, f, g] = False
        elif kind == "few_alive":
            for i in range(1, P - P // 2 + 1):
                crashed[(lead + i) % P, g] = True
        elif kind in ("stale_at_boundary", "stale_before_boundary"):
            a["state"][f, g] = LEADER
            crashed[f, g] = True
            a["election_elapsed"][f, g] = et - horizon - (kind == "stale_before_boundary")
    return tsim.SimState(**a), crashed


def random_planes(P, n, seed, check_quorum):
    """Random planes for every field the invariant reads: any roles, terms
    and timers (some near the int32 limits, so `+ horizon` wraps), crashes
    and masks anywhere; a third of the groups settled-like, so some pass."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape=(P, n)):
        return torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32))

    top = 2**31 - 1
    ee = torch.where(torch.from_numpy(rng.random((P, n)) < 0.1),
                     ints(top - 40, top + 1), ints(-3, 25))
    state = ints(0, 3)
    quiet = torch.from_numpy(rng.random(n) < 0.35)
    lead = torch.from_numpy(rng.integers(0, P, size=n))
    one = torch.arange(P)[:, None] == lead[None, :]
    state = torch.where(quiet[None, :], torch.where(one, LEADER, 0), state).to(torch.int32)
    term = torch.where(quiet[None, :], 4, ints(-2, 4)).to(torch.int32)
    planes = dict(
        term=term, state=state, election_elapsed=ee,
        randomized_timeout=ints(5, 30),
        voter_mask=torch.from_numpy(rng.random((P, n)) < 0.9),
        outgoing_mask=torch.from_numpy(rng.random((P, n)) < 0.05),
        recent_active=(torch.from_numpy(rng.random((P, P, n)) < 0.7)
                       if check_quorum else None),
        transferee=torch.where(torch.from_numpy(rng.random((P, n)) < 0.05),
                               ints(-1, P + 1), 0).to(torch.int32),
    )
    zero = torch.zeros((P, n), dtype=torch.int32)
    rest = {f: zero for f in tsim.SimState._fields if f not in planes}
    rest.update(matched=torch.zeros((P, P, n), dtype=torch.int32),
                agree=torch.zeros((P, P, n), dtype=torch.int32),
                learner_mask=torch.zeros((P, n), dtype=torch.bool))
    crashed = torch.from_numpy(rng.random((P, n)) < 0.15)
    return tsim.SimState(**{**rest, **planes}), crashed


def jax_mask(cfg, st, crashed, horizon, reconfig_pending=None, read_pending=None):
    """The JAX package's pallas_step.steady_mask on the same planes."""
    import jax.numpy as jnp

    from raft_tpu.multiraft import pallas_step as jps
    from raft_tpu.multiraft import sim as jsim

    jcfg = jsim.SimConfig(**{f: getattr(cfg, f) for f in (
        "n_groups", "n_peers", "election_tick", "heartbeat_tick",
        "check_quorum", "pre_vote", "transfer", "blackbox")})
    jst = jsim.SimState(**{f: None if v is None else jnp.asarray(v.numpy())
                           for f, v in st._asdict().items()})
    opt = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    return np.asarray(jps.steady_mask(
        jcfg, jst, jnp.asarray(crashed.numpy()), horizon,
        reconfig_pending=opt(reconfig_pending), read_pending=opt(read_pending)))


def check(cfg, st, crashed, horizon, reconfig_pending=None, read_pending=None,
          jax=True):
    """The host body's mask and flag against the composition's and, with
    `jax`, the reference's; returns the mask."""
    want = tfs.steady_mask(cfg, st, crashed, horizon,
                           reconfig_pending=reconfig_pending, read_pending=read_pending)
    got, flag = pk.host_invariant(cfg, st, crashed, horizon, reconfig_pending,
                                  read_pending)
    assert torch.equal(got, want)
    assert flag == bool(want.all())
    if reconfig_pending is None and read_pending is None:
        assert flag == bool(tfs.steady_predicate(cfg, st, crashed, horizon))
    if jax:
        np.testing.assert_array_equal(
            jax_mask(cfg, st, crashed, horizon, reconfig_pending, read_pending),
            want.numpy())
    return want


def pending_rows(n, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random(n) < 0.3), torch.from_numpy(rng.random(n) < 0.3))


@pytest.mark.parametrize("P", [3, 5, 7, 16])
@pytest.mark.parametrize("name", [*CONFIGS, *DEGENERATE])
@pytest.mark.parametrize("horizon", [1, 8, 32])
@pytest.mark.parametrize("extras", ["bare", "transferee+pending"])
def test_body_matches_composition_and_jax(P, name, horizon, extras):
    base = DEGENERATE[name][1] if name in DEGENERATE else name
    st = settled(base, P)
    transfer = extras != "bare"
    cfg = config(name, P, transfer=transfer)
    broken, crashed = crafted(st, cfg, horizon)
    if not transfer:
        broken = broken._replace(transferee=None)
    rows = pending_rows(G, P * horizon) if transfer else (None, None)
    mask = check(cfg, broken, crashed, horizon, *rows)
    if name in DEGENERATE:
        assert not mask.any()
    # The untouched groups of a settled fleet pass a short horizon.
    if name in CONFIGS and horizon == 1:
        keep = torch.ones(G, dtype=torch.bool) if rows[0] is None else ~(rows[0] | rows[1])
        steady = torch.tensor([KINDS[g % len(KINDS)] == "steady" for g in range(G)])
        assert mask[steady & keep].all()


@pytest.mark.parametrize("P", [1, 2, 3, 5, 16, 33])
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("horizon", [1, 8])
def test_body_matches_on_random_planes(P, name, horizon):
    cfg = config(name, P, n_groups=300, transfer=True)
    st, crashed = random_planes(P, 300, 1000 * P + horizon, cfg.check_quorum)
    rows = pending_rows(300, P)
    check(cfg, st, crashed, horizon, jax=P <= 16)
    check(cfg, st, crashed, horizon, *rows, jax=False)


@pytest.mark.parametrize("name", ["plain-hb1", "cq-pv"])
def test_flag_reduces_block_by_block(name):
    """Over 700 groups (three blocks of csrc's 256): the flag is set where
    every group passes and cleared by one failing group in any block."""
    n = 700
    st = settled(name, 3, n_groups=n)
    cfg = config(name, 3, n_groups=n)
    crashed = torch.zeros((3, n), dtype=torch.bool)
    assert check(cfg, st, crashed, 8, jax=False).all()
    lead_of = (st.state == LEADER).to(torch.int64).argmax(0)
    for g in (0, 255, 256, 511, 699):
        term = st.term.clone()
        term[(lead_of[g] + 1) % 3, g] -= 1
        mask = check(cfg, st._replace(term=term), crashed, 8, jax=False)
        assert int((~mask).sum()) == 1 and not mask[g]


def test_body_refuses_what_the_composition_refuses():
    cfg = config("cq", 3)
    st = settled("cq", 3)._replace(recent_active=None)
    crashed = torch.zeros((3, G), dtype=torch.bool)
    with pytest.raises(ValueError, match="recent_active"):
        tfs.steady_mask(cfg, st, crashed)
    with pytest.raises(ValueError, match="recent_active"):
        pk.host_invariant(cfg, st, crashed)
    # A config that rejects every group reads no row, in both.
    degenerate = config("cq-et-le-hb", 3)
    assert not tfs.steady_mask(degenerate, st, crashed).any()
    assert not pk.host_invariant(degenerate, st, crashed)[0].any()
    with pytest.raises(ValueError, match="int32"):
        pk.host_invariant(config("plain-hb1", 3), settled("plain-hb1", 3), crashed, 2**31)
    with pytest.raises(ValueError, match="crashed"):
        pk.host_invariant(config("plain-hb1", 3), settled("plain-hb1", 3),
                          crashed.to(torch.int32))


def test_masks_in_any_layout():
    """A strided crash mask and strided pending rows read as their
    contiguous copies do, as the composition reads them."""
    cfg = config("cq-pv", 3)
    st, crashed = crafted(settled("cq-pv", 3), cfg, 8)
    strided = crashed.t().contiguous().t()
    rows = [torch.stack([r, ~r], 1)[:, 0] for r in pending_rows(G, 5)]
    assert not strided.is_contiguous() and not rows[0].is_contiguous()
    want = check(cfg, st, crashed, 8, *(r.contiguous() for r in rows), jax=False)
    assert torch.equal(check(cfg, st, strided, 8, *rows, jax=False), want)


def test_cpu_tensors_take_the_composition():
    before = pk.steady_invariant.launches
    cfg = config("cq-pv", 3)
    st = settled("cq-pv", 3)
    crashed = torch.zeros((3, G), dtype=torch.bool)
    assert bool(tfs.steady_predicate(cfg, st, crashed, 8))
    tfs.fast_multi_round(cfg, 8)(st, crashed, torch.ones(G, dtype=torch.int32))
    assert pk.steady_invariant.launches == before
    assert pk.predicate_work(3, 1_000_000, False) == 57_000_004
    assert pk.predicate_work(3, 1_000_000, True) == 60_000_004


def test_a_repeat_load_is_a_lookup(monkeypatch):
    """The fused wrappers load their library (and with it the predicate's)
    on every call: once declared, a library is returned without a lock or
    a load."""
    from raft_tpu_torch.multiraft import _build

    lib = _build.load_predicate_host()

    def reload(*_):
        raise AssertionError("a declared library was loaded again")

    monkeypatch.setattr(_build, "_load", reload)
    assert _build.load_predicate_host() is lib


def _store_loss(P, n):
    """The replicas on one of 30 stores down (peer p of group g on store
    (g * P + p) % 30)."""
    g = torch.arange(n)[None, :]
    p = torch.arange(P)[:, None]
    return ((g * P + p) % 30 == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,k", [("plain-hb1", 32), ("cq-pv", 8)])
def test_kernel_matches_composition_on_the_card(name, k):
    """At 1M groups x 3: the kernel's flag and mask against the composition
    on CPU copies, on the settled fleet and with a store's replicas down,
    with and without the pending rows; then each profiled fast_multi_round
    block holds one predicate-kernel record and at most two device
    operations under dispatch.predicate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import tempfile

    from raft_tpu_torch.tools import span_split

    n, P = 1_000_000, 3
    cfg = config(name, P, n_groups=n)
    s = tsim.ClusterSim(cfg, device="cuda")
    append = torch.ones(n, dtype=torch.int32, device="cuda")
    s.run(64, None, append)
    st = s.state
    cpu = tsim.SimState(*(None if v is None else v.cpu() for v in st))
    for crashed in (torch.zeros((P, n), dtype=torch.bool), _store_loss(P, n)):
        on_card = crashed.cuda()
        for horizon in (1, k):
            want = tfs.steady_mask(cfg, cpu, crashed, horizon)
            launched = pk.steady_invariant.launches
            assert torch.equal(tfs.steady_mask(cfg, st, on_card, horizon).cpu(), want)
            pred = tfs.steady_predicate(cfg, st, on_card, horizon)
            assert pred.dim() == 0 and pred.dtype == torch.bool
            assert bool(pred) == bool(want.all())
            assert pk.steady_invariant.launches == launched + 2
            rows = pending_rows(n, horizon)
            want = tfs.steady_mask(cfg, cpu, crashed, horizon, *rows)
            got = tfs.steady_mask(cfg, st, on_card, horizon, *(r.cuda() for r in rows))
            assert torch.equal(got.cpu(), want)
    block = tfs.fast_multi_round(cfg, k)
    none = torch.zeros((P, n), dtype=torch.bool, device="cuda")
    assert bool(tfs.steady_predicate(cfg, st, none, k))
    block(st, none, append)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with torch.profiler.record_function("block"):
                block(st, none, append)
            with torch.profiler.record_function("sync"):
                torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as trace:
            events = json.load(trace)["traceEvents"]
    # A second profiler session in one process drops the device records of
    # its first milliseconds (seen on an H100), so the first block is left out.
    second = sorted(float(e["ts"]) for e in events if e.get("name") == "block")[1]
    out = span_split.split([e for e in events if float(e.get("ts", 0)) >= second])
    pred = out["predicate"]
    assert pred["fused_blocks"] == 2
    assert pred["kernel_records_min"] == pred["kernel_records_max"] == 1
    assert 1 <= pred["launches_min"] <= pred["launches_max"] <= 2
