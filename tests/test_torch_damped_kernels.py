"""The check-quorum slice's kernels on the CPU, against the JAX package:
`committed_index`, `check_quorum_active` and `cq_boundary_safe` on random
planes (joint and empty configs, the `lossy=` mask); the port's fused damped
round (`damped_round`, the plain version on CPU tensors) against the Pallas
`_steady_damped_kernel` in interpret mode at k=4, with check_quorum on and
off and loss on and off, on settled states with and without crashed
followers and on random states; and the CUDA kernel's body
(csrc/damped_body.cuh) built for the host with g++ and held to
`damped_rounds_reference`.  Every plane is int32 or bool, so the tolerance
is exact equality."""

import ctypes
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import _build, fused_step
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.damped_kernel import (
    OUTPUT_NAMES,
    damped_rounds,
    damped_body_work,
    damped_rounds_reference,
    damped_work,
)

from test_torch_sim import assert_states_equal
from test_torch_sim_fuzz import random_state

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ is needed to build the host shim"
)

# Looked up by name: the JAX package's parity-obligation baseline records,
# for each of its kernels, the test files whose code names it.
NAMES = ("committed_index", "check_quorum_active", "cq_boundary_safe")
JAX_K = {n: getattr(jk, n) for n in NAMES}
TORCH_K = {n: getattr(tk, n) for n in NAMES}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_masks(rng, P, G):
    """Voter and outgoing masks with empty, single-half and joint groups."""
    voter = rng.random((P, G)) < 0.6
    outgoing = (rng.random((P, G)) < 0.5) & (rng.random(G) < 0.4)
    voter[:, :4] = False  # empty incoming half
    outgoing[:, 4:8] = False
    voter[:, 8:10] = False
    outgoing[:, 8:10] = False  # both halves empty
    return voter, outgoing


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6, 7])
def test_committed_index_matches_jax(P):
    rng = np.random.default_rng(P)
    G = 120
    matched = rng.integers(0, 50, size=(G, 3, P)).astype(np.int32)
    voter = rng.random((G, 3, P)) < 0.6
    voter[:5] = False  # empty configs give INF
    want = np.asarray(JAX_K["committed_index"](jnp.asarray(matched), jnp.asarray(voter)))
    got = TORCH_K["committed_index"](_t(matched), _t(voter))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:5] == tk.INF).all()
    # Against the odd-even network the plain step uses.
    m2, v2 = _t(matched[:, 0, :].T), _t(voter[:, 0, :].T)
    np.testing.assert_array_equal(
        got[:, 0].numpy(), tsim._quorum_index(m2, v2).numpy()
    )


@pytest.mark.parametrize("P", [1, 2, 3, 5, 7])
def test_check_quorum_active_matches_jax(P):
    rng = np.random.default_rng(10 + P)
    G = 150
    ra = rng.random((P, P, G)) < 0.5
    voter, outgoing = random_masks(rng, P, G)
    want = np.asarray(JAX_K["check_quorum_active"](*map(jnp.asarray, (ra, voter, outgoing))))
    got = TORCH_K["check_quorum_active"](*map(_t, (ra, voter, outgoing)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and (P == 1 or not want.all())  # a lone peer is its quorum


@pytest.mark.parametrize("P", [1, 3, 5, 7])
@pytest.mark.parametrize("horizon", [1, 4, 32])
def test_cq_boundary_safe_matches_jax(P, horizon):
    rng = np.random.default_rng(100 * P + horizon)
    G = 200
    ra = rng.random((P, P, G)) < 0.7
    voter, outgoing = random_masks(rng, P, G)
    state = rng.integers(0, 4, size=(P, G)).astype(np.int32)
    crashed = rng.random((P, G)) < 0.2
    ee = rng.integers(0, 40, size=(P, G)).astype(np.int32)
    lossy = rng.random(G) < 0.5
    args = (ra, voter, outgoing, state, crashed, ee)
    for lossy_arg in (None, lossy):
        want = np.asarray(JAX_K["cq_boundary_safe"](
            *map(jnp.asarray, args), horizon, 40,
            lossy=None if lossy_arg is None else jnp.asarray(lossy_arg),
        ))
        got = TORCH_K["cq_boundary_safe"](
            *map(_t, args), horizon, 40,
            lossy=None if lossy_arg is None else _t(lossy_arg),
        )
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(lossy_arg is None))
        assert want.any() and not want.all()


# --- the fused damped round against the Pallas kernel ----------------------

FLAGS = {"cq": dict(check_quorum=True), "pv": dict(pre_vote=True),
         "cqpv": dict(check_quorum=True, pre_vote=True)}


def cfgs(G, P, flags, election_tick=10):
    kw = dict(n_groups=G, n_peers=P, election_tick=election_tick, **FLAGS[flags])
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


def to_jax(tst):
    return jsim.SimState(**{
        f: None if v is None else jnp.asarray(v.numpy())
        for f, v in tst._asdict().items()
    })


@functools.lru_cache(maxsize=None)
def settled_port(G, P, flags, rounds=40):
    """A damped state settled by `rounds` port rounds of one append a group
    (the port's damped step equals JAX's: test_torch_damped.py)."""
    _, tcfg = cfgs(G, P, flags)
    s = tsim.ClusterSim(tcfg, device="cpu")
    s.run(rounds, None, torch.ones(G, dtype=torch.int32))
    return s.state


def crashed_followers(st, P, G):
    crashed = torch.zeros((P, G), dtype=torch.bool)
    lead = st.state.eq(2).to(torch.int64).argmax(0)
    idx = torch.arange(G)
    crashed[(lead + 1) % P, idx] = idx % 2 == 0
    return crashed


def random_damped_state(P, G, seed):
    """Random planes for every field, recent_active included: several or
    no leaders, crashes anywhere, every branch of the kernel somewhere."""
    arrays = random_state(P, G, seed)
    rng = np.random.default_rng(seed + 7)
    arrays["recent_active"] = rng.random((P, P, G)) < 0.5
    arrays["state"] = np.where(rng.random((P, G)) < 0.4, 2, arrays["state"]).astype(np.int32)
    return tsim.state_from_numpy(arrays, "cpu")


@functools.lru_cache(maxsize=None)
def _pallas(G, P, flags, k, loss):
    jcfg, _ = cfgs(G, P, flags)
    return jax.jit(jps.steady_round(jcfg, rounds=k, with_chaos=loss, interpret=True))


def loss_plane(P, G, seed):
    rng = np.random.default_rng(seed)
    loss = rng.integers(0, 4000, size=(P, P, G)).astype(np.int32)
    loss[:, :, ::3] = 0
    return loss


def check_against_pallas(tst, crashed, flags, loss, rb, k=4):
    P, G = tst.state.shape
    _, tcfg = cfgs(G, P, flags)
    append = np.ones(G, np.int32)
    append[::4] = 0
    jargs = (to_jax(tst), jnp.asarray(crashed.numpy()), jnp.asarray(append))
    targs = (tst, crashed, torch.from_numpy(append))
    fn = fused_step.damped_round(tcfg, k, with_chaos=loss)
    if loss:
        lr = loss_plane(P, G, rb % 97)
        want = _pallas(G, P, flags, k, True)(*jargs, jnp.asarray(lr), jnp.int32(rb))
        got = fn(*targs, torch.from_numpy(lr), rb)
    else:
        want = _pallas(G, P, flags, k, False)(*jargs)
        got = fn(*targs)
    assert_states_equal(want, got, f"{flags} loss={loss}")
    return got


@pytest.mark.parametrize("flags", ["cq", "pv"])
@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("crash", [False, True])
def test_damped_round_matches_pallas_on_settled_states(flags, loss, crash):
    P, G = 3, 16
    st = settled_port(G, P, flags)
    crashed = crashed_followers(st, P, G) if crash else torch.zeros((P, G), dtype=torch.bool)
    before = damped_rounds.launches
    got = st
    for b in range(3):  # blocks cross the election_tick=10 boundary
        got = check_against_pallas(got, crashed, flags, loss, 40 + 4 * b)
    assert damped_rounds.launches == before  # CPU tensors: no kernel launch
    # Groups with appends (all but every fourth) keep committing.
    grew = got.commit.amax(0) > st.commit.amax(0)
    assert grew[1::4].all() and grew[2::4].all() and grew[3::4].all()


@pytest.mark.parametrize("flags", ["cq", "pv"])
@pytest.mark.parametrize("loss", [False, True])
def test_damped_round_matches_pallas_on_random_states(flags, loss):
    for seed in (0, 1):
        st = random_damped_state(5, 16, seed)
        crashed = _t(np.random.default_rng(seed).random((5, 16)) < 0.2)
        check_against_pallas(st, crashed, flags, loss, 2**31 - 4 if seed else 9)


def test_damped_round_needs_recent_active():
    _, tcfg = cfgs(4, 3, "cq")
    st = tsim.init_state(tsim.SimConfig(4, 3), device="cpu")
    args = (st, torch.zeros((3, 4), dtype=torch.bool), torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="recent_active"):
        fused_step.damped_round(tcfg, 4)(*args)
    with pytest.raises(ValueError):
        fused_step.damped_round(tsim.SimConfig(4, 3), 4)


# --- the CUDA body, built with g++, against the plain version --------------


def _host_rounds(args, kw, tsc=None):
    """The g++ build of the body; with `tsc`, its with_health instance,
    tsc' appended to the outputs."""
    lib = _build.load_damped_host()
    P, G = args[0].shape
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((P, G), dtype=torch.bool))
    outs.append(torch.empty((P, P, G), dtype=torch.int32))
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    ptrs = [None if a is None else a.contiguous().data_ptr() for a in args]
    rc = lib.damped_round_host(
        *ptrs, *[t.data_ptr() for t in outs],
        *[None if t is None else t.data_ptr() for t in (tsc, tsc_out)],
        G, P, kw["round_base"], kw["rounds"], kw["election_tick"],
        kw["heartbeat_tick"], int(kw["with_cq"]), int(args[13] is not None),
        int(tsc is not None),
    )
    assert rc == 0
    return outs + ([] if tsc is None else [tsc_out])


def random_operands(P, G, seed, loss):
    """Random kernel operands, small enough that no int32 sum wraps."""
    rng = np.random.default_rng(seed)

    def ints(hi, shape=(P, G)):
        return _t(rng.integers(0, hi, size=shape).astype(np.int32))

    def bools(p):
        return _t(rng.random((P, G)) < p)

    lr = None
    if loss:
        lr = rng.integers(0, tk.LOSS_SCALE + 1, size=(P, P, G))
        lr = _t(np.where(rng.random((P, P, G)) < 0.5, lr // 20, lr).astype(np.int32))
    return (
        ints(3), ints(P + 1), ints(3), ints(12), ints(40), ints(5), ints(40),
        ints(40), bools(0.5), bools(0.8), bools(0.9), bools(0.2),
        ints(40, (P, P, G)), lr, ints(40, (G,)), ints(5, (G,)), ints(3, (G,)),
    )


def assert_host_matches(args, **kw):
    want = damped_rounds_reference(*args, **kw)
    got = _host_rounds(args, kw)
    for name, w, g in zip(OUTPUT_NAMES, want, got):
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name} {kw}")
    return want


@needs_gxx
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("with_cq", [False, True])
@pytest.mark.parametrize("loss", [False, True])
def test_host_body_matches_reference_on_random_planes(P, k, with_cq, loss):
    args = random_operands(P, 37, P * 100 + k, loss)  # 37: not a block multiple
    for rb, ticks in ((150, (10, 1)), (2**31 - k, (6, 3)), (0, (3, 2))):
        assert_host_matches(args, round_base=rb, rounds=k, election_tick=ticks[0],
                            heartbeat_tick=ticks[1], with_cq=with_cq)


@needs_gxx
@pytest.mark.parametrize("flags", ["cq", "cqpv"])
@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("loss", [False, True])
def test_host_body_matches_reference_on_settled_planes(flags, crash, loss):
    P, G = 5, 37
    st = settled_port(G, P, flags)
    crashed = crashed_followers(st, P, G) if crash else torch.zeros((P, G), dtype=torch.bool)
    lr = _t(loss_plane(P, G, 3)) if loss else None
    args = fused_step.damped_operands(st, crashed, torch.ones(G, dtype=torch.int32), lr)
    want = assert_host_matches(args, round_base=40, rounds=32, election_tick=10,
                               heartbeat_tick=1, with_cq=True)
    before, after = args[6].amax(0), want[6].amax(0)
    assert (after >= before).all() and (after > before).any()


@needs_gxx
@pytest.mark.parametrize("P", [1, 2, 4, 6, 7])
def test_host_body_every_instantiated_peer_count(P):
    for with_cq in (False, True):
        for loss in (False, True):
            args = random_operands(P, 19, P, loss)
            assert_host_matches(args, round_base=1000, rounds=5, election_tick=4,
                                heartbeat_tick=2, with_cq=with_cq)


@needs_gxx
def test_host_body_rejects_what_it_cannot_take():
    lib = _build.load_damped_host()
    null = ctypes.c_void_p(0)
    assert lib.damped_round_host(*([null] * 29), 4, 8, 0, 1, 10, 1, 1, 0, 0) != 0
    # with_loss needs the loss_rate pointer, with_health the tsc pointers
    assert lib.damped_round_host(*([null] * 29), 4, 3, 0, 1, 10, 1, 1, 1, 0) != 0
    assert lib.damped_round_host(*([null] * 29), 4, 3, 0, 1, 10, 1, 1, 0, 1) != 0


# --- the body's leader arms: none, one and several acting leaders ----------

MESH_BASE = 8_300_000  # one of chip_smoke.py's mesh group bases, near 2**23


def place_leaders(P, G, n_leaders, seed, slot=None):
    """(state, crashed) planes with exactly `n_leaders` acting leaders in
    every group, set on purpose: slots g, g + 1, ... (mod P), or `slot`
    alone; the other peers followers or candidates, one of them in every
    odd group in the leader role but crashed, so not acting."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 2, size=(P, G)).astype(np.int32)
    crashed = rng.random((P, G)) < 0.2
    for g in range(G):
        lead = [slot] if slot is not None else [(g + j) % P for j in range(n_leaders)]
        state[lead, g] = tk.ROLE_LEADER
        crashed[lead, g] = False
        rest = [p for p in range(P) if p not in lead]
        if rest and g % 2:
            q = rest[g % len(rest)]
            state[q, g], crashed[q, g] = tk.ROLE_LEADER, True
    state, crashed = _t(state), _t(crashed)
    acting = (state == tk.ROLE_LEADER) & ~crashed
    assert (acting.sum(0) == n_leaders).all()
    return state, crashed


def leader_operands(P, G, n_leaders, seed, loss, slot=None):
    """random_operands with place_leaders' roles and crashes."""
    args = list(random_operands(P, G, seed, loss))
    args[0], args[11] = place_leaders(P, G, n_leaders, seed + 1, slot)
    return tuple(args)


def _host_at(args, kw, tsc, strided):
    """damped_round_host_at (the body over a plain array) or, `strided`,
    damped_round_host_strided_at (over the CUDA build's shared-memory
    layout), from the narrow or the wide library by P."""
    P, G = args[0].shape
    lib = _build.load_damped_host(P)
    fn = lib.damped_round_host_strided_at if strided else lib.damped_round_host_at
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((P, G), dtype=torch.bool))
    outs.append(torch.empty((P, P, G), dtype=torch.int32))
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = fn(
        *[None if a is None else a.contiguous().data_ptr() for a in args],
        *[t.data_ptr() for t in outs],
        *[None if t is None else t.data_ptr() for t in (tsc, tsc_out)],
        G, P, kw["round_base"], kw["rounds"], kw["election_tick"],
        kw["heartbeat_tick"], int(kw["with_cq"]), int(args[13] is not None),
        int(tsc is not None), kw["group_base"],
    )
    assert rc == 0
    return outs + ([] if tsc is None else [tsc_out])


def assert_arms_match(args, kw):
    """Both storages of the g++ body, both health variants, equal to the
    plain version."""
    G = args[0].shape[1]
    tsc = _t(np.random.default_rng(G).integers(0, 100, size=G).astype(np.int32))
    for t in (None, tsc):
        want = damped_rounds_reference(*args, t, **kw)
        for strided in (False, True):
            got = _host_at(args, kw, t, strided)
            for name, w, g in zip(OUTPUT_NAMES + ("tsc",), want, got):
                assert w.dtype == g.dtype, name
                np.testing.assert_array_equal(
                    g.numpy(), w.numpy(),
                    err_msg=f"{name} strided={strided} health={t is not None} {kw}")
    return want


@needs_gxx
@pytest.mark.parametrize("P", [2, 5, 8, 15])
@pytest.mark.parametrize("n_leaders", [0, 1, 3])
@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("group_base", [0, MESH_BASE])
def test_host_body_leader_arms(P, n_leaders, loss, group_base):
    """0, 1 and 3 acting leaders (2 at P = 2): no draw, the leader's row and
    column from registers, and each leader's links from the plane."""
    n = min(n_leaders, P)
    args = leader_operands(P, 13, n, 1000 * P + 10 * n + loss, loss)
    kw = dict(round_base=2**31 - 16, rounds=16, election_tick=6, heartbeat_tick=1,
              with_cq=bool(n % 2), group_base=group_base)
    want = assert_arms_match(args, kw)
    if loss and n and P >= 5:  # the draws gate something (at P = 2 they may not)
        dry = damped_rounds_reference(*args[:13], None, *args[14:], **kw)
        assert any(not torch.equal(w, d) for w, d in zip(want, dry))


@needs_gxx
@pytest.mark.parametrize("P", [5, 15])
@pytest.mark.parametrize("slot", ["first", "last"])
def test_host_body_single_leader_at_either_end(P, slot):
    """One acting leader at slot 0 or P - 1 in every group: the leader's
    row and column rates, and its draw lanes, at the ends of the block."""
    where = 0 if slot == "first" else P - 1
    args = leader_operands(P, 13, 1, 7 * P + where, True, slot=where)
    for group_base in (0, MESH_BASE):
        assert_arms_match(args, dict(round_base=40, rounds=16, election_tick=6,
                                     heartbeat_tick=1, with_cq=True,
                                     group_base=group_base))


@needs_gxx
@pytest.mark.parametrize("n_leaders, slot", [(0, None), (1, None), (3, None), (1, 4)])
@pytest.mark.parametrize("loss", [False, True])
def test_leader_arms_match_pallas(n_leaders, slot, loss):
    """Random states at P = 5 with exactly 0, 1 or 3 acting leaders (or one
    at slot P - 1 in every group): the port's damped round against the
    Pallas kernel in interpret mode, and the g++ body, both storages, on
    the same operands against the plain version, so each arm of the body
    meets the JAX package on one input."""
    P, G, rb = 5, 16, 2**31 - 4
    st = random_damped_state(P, G, 60 + n_leaders)
    state, crashed = place_leaders(P, G, n_leaders, 70 + n_leaders, slot)
    st = st._replace(state=state)
    got = check_against_pallas(st, crashed, "cq", loss, rb)
    assert not torch.equal(got.commit, st.commit) or n_leaders == 0
    _, tcfg = cfgs(G, P, "cq")
    append = torch.ones(G, dtype=torch.int32)
    append[::4] = 0  # as check_against_pallas
    rates = _t(loss_plane(P, G, rb % 97)) if loss else None
    args = fused_step.damped_operands(st, crashed, append, rates)
    kw = dict(round_base=rb, rounds=4, election_tick=tcfg.election_tick,
              heartbeat_tick=tcfg.heartbeat_tick, with_cq=True, group_base=0)
    want = assert_arms_match(args, kw)
    if loss and n_leaders:  # the draws gate something
        dry = damped_rounds_reference(*args[:13], None, *args[14:], **kw)
        assert any(not torch.equal(w, d) for w, d in zip(want, dry))


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    args = random_operands(3, 16, 9, True)
    kw = dict(round_base=7, rounds=4, election_tick=10, heartbeat_tick=1, with_cq=True)
    before = damped_rounds.launches
    got = damped_rounds(*args, **kw)
    want = damped_rounds_reference(*args, **kw)
    assert damped_rounds.launches == before
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError):
        damped_rounds(*args, **{**kw, "round_base": 2**31 - 3})
    # Without loss the round base is not read.
    plain = args[:13] + (None,) + args[14:]
    damped_rounds(*plain, **{**kw, "round_base": 2**31 - 3})


def test_damped_work_counts():
    nbytes, ops = damped_work(5, 100_000, 32)
    # 8 int32 + 4 one-byte [P, G] planes, agree and 3 rows in; 8 int32
    # and 1 one-byte planes and agree out: 557 bytes a group.
    assert nbytes == 557 * 100_000
    # 1,542 operations a group-round at P=5 with check_quorum, no loss.
    assert ops == 1542 * 32 * 100_000
    assert damped_work(5, 10, 1, with_cq=False)[1] == (1542 - 15) * 10
    nb_loss, ops_loss = damped_work(5, 10, 1, with_loss=True)
    assert nb_loss == 557 * 10 + 4 * 8 * 10
    assert ops_loss == (1542 - 10 + 10 + 12 * 8 + 60) * 10


def test_damped_body_work_counts():
    """The body's count: the plain version's bytes, fewer operations."""
    nbytes, ops = damped_body_work(5, 100_000, 32)
    assert nbytes == damped_work(5, 100_000, 32)[0]
    # 739 operations a group-round at P=5 with check_quorum, no loss:
    # 2P² + 117P + 6 × 10 comparators + 43 + 1; 140 once a group.
    assert ops == (739 * 32 + 140) * 100_000
    assert damped_body_work(5, 10, 1, with_cq=False)[1] == (738 + 140) * 10
    nb_loss, ops_loss = damped_body_work(5, 10, 1, with_loss=True)
    assert nb_loss == damped_work(5, 10, 1, with_loss=True)[0]
    assert ops_loss == (739 + 12 + 15 * 8 + 140 + 4) * 10
    # with_health adds health_work's count, as damped_work does.
    h = damped_body_work(5, 10, 8, with_health=True)[1] - damped_body_work(5, 10, 8)[1]
    assert h == damped_work(5, 10, 8, with_health=True)[1] - damped_work(5, 10, 8)[1]
    for P in range(1, 16):
        for flags in ({}, dict(with_loss=True), dict(with_health=True)):
            assert damped_body_work(P, 7, 8, **flags)[1] < damped_work(P, 7, 8, **flags)[1]
