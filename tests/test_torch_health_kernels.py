"""The instrumentation slice's kernels on the CPU, against the JAX package:
the counter fold, the health fold (with the churn-window reset) and the
fixed-size health summary (ties in the worst-offender list, every output
int32), on random planes made with numpy; then the with_health variant of
each CUDA kernel's body (csrc/*_body.cuh) built for the host with g++ and
held to its plain PyTorch version, on random planes with random
ticks_since_commit rows and on settled states with crashed followers.
Every plane is int32 or bool, so the tolerance is exact equality."""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu_torch.multiraft import _build, fused_step
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft.chaos_kernel import chaos_rounds, chaos_rounds_reference
from raft_tpu_torch.multiraft.damped_kernel import damped_rounds, damped_rounds_reference
from raft_tpu_torch.multiraft.steady_kernel import (
    health_work,
    steady_rounds,
    steady_rounds_reference,
    steady_work,
)

import test_torch_chaos_kernels as chaos_tests
import test_torch_damped_kernels as damped_tests
import test_torch_kernel_body as steady_tests

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ is needed to build the host shim"
)

# Looked up by name: the JAX package's parity-obligation baseline records,
# for each of its kernels, the test files whose code names it.
NAMES = ("zero_counters", "count_events", "zero_health", "update_health",
         "health_summary")
JAX_K = {n: getattr(jk, n) for n in NAMES}
TORCH_K = {n: getattr(tk, n) for n in NAMES}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_plane_layouts_match_jax():
    for name in ("CTR_CAMPAIGNS", "CTR_HEARTBEATS", "CTR_ELECTIONS_WON",
                 "CTR_COMMIT_ENTRIES", "N_COUNTERS", "COUNTER_NAMES",
                 "HP_LEADERLESS", "HP_SINCE_COMMIT", "HP_TERM_BUMPS",
                 "HP_VOTE_SPLITS", "N_HEALTH_PLANES", "HEALTH_PLANE_NAMES",
                 "LAG_BUCKET_BOUNDS", "N_LAG_BUCKETS", "HS_LEADERLESS",
                 "HS_STALLED_LEADERLESS", "HS_COMMIT_STALLED", "HS_CHURNING",
                 "N_HEALTH_COUNTS", "HEALTH_COUNT_NAMES"):
        assert getattr(tk, name) == getattr(jk, name), name
    c = TORCH_K["zero_counters"]("cpu")
    h = TORCH_K["zero_health"](5, "cpu")
    assert c.dtype == h.dtype == torch.int32
    assert tuple(c.shape) == np.asarray(JAX_K["zero_counters"]()).shape
    assert tuple(h.shape) == np.asarray(JAX_K["zero_health"](5)).shape
    assert not c.any() and not h.any()
    st = tsim.init_health(tsim.SimConfig(7, 3), device="cpu")
    assert tuple(st.planes.shape) == (tk.N_HEALTH_PLANES, 7) and st.window_pos == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_events_matches_jax(seed):
    rng = np.random.default_rng(seed)
    P, G = 5, 16
    masks = [rng.random((P, G)) < p for p in (0.2, 0.5, 0.1)]
    delta = rng.integers(0, 1000, size=(P, G)).astype(np.int32)
    if seed == 2:  # a sum past 2**31 wraps in both
        delta[:] = 2**30
    start = rng.integers(0, 100, size=4).astype(np.int32)
    want = np.asarray(JAX_K["count_events"](
        jnp.asarray(start), *map(jnp.asarray, masks), jnp.asarray(delta)))
    got = TORCH_K["count_events"](_t(start), *map(_t, masks), _t(delta))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [1, 4, 8])
def test_update_health_matches_jax_across_window_resets(window):
    rng = np.random.default_rng(window)
    G, rounds = 12, 3 * window + 2
    jplanes, jpos = JAX_K["zero_health"](G), jnp.int32(0)
    tplanes, tpos = TORCH_K["zero_health"](G, "cpu"), 0
    resets = 0
    for _ in range(rounds):
        facts = (rng.random(G) < 0.6, rng.random(G) < 0.5,
                 rng.integers(0, 3, size=G).astype(np.int32), rng.random(G) < 0.2)
        jplanes, jpos = JAX_K["update_health"](
            jplanes, jpos, window, *map(jnp.asarray, facts))
        tplanes, tpos = TORCH_K["update_health"](tplanes, tpos, window, *map(_t, facts))
        assert tplanes.dtype == torch.int32 and isinstance(tpos, int)
        np.testing.assert_array_equal(tplanes.numpy(), np.asarray(jplanes))
        assert tpos == int(jpos)
        resets += tpos == 0
    assert resets >= 2


@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_health_summary_matches_jax_with_ties(k):
    rng = np.random.default_rng(k)
    G = 16
    planes = np.zeros((tk.N_HEALTH_PLANES, G), np.int32)
    planes[tk.HP_LEADERLESS] = rng.integers(0, 4, G)  # many ties
    planes[tk.HP_SINCE_COMMIT] = rng.integers(0, 4, G)
    planes[tk.HP_SINCE_COMMIT, :3] = (16, 40, 70)  # the top histogram buckets
    planes[tk.HP_TERM_BUMPS] = rng.integers(0, 6, G)
    planes[tk.HP_VOTE_SPLITS] = rng.integers(0, 6, G)
    want = JAX_K["health_summary"](jnp.asarray(planes), 2, 3, 4, k)
    got = TORCH_K["health_summary"](_t(planes), 2, 3, 4, k)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    score = np.maximum(planes[tk.HP_SINCE_COMMIT], planes[tk.HP_LEADERLESS])
    np.testing.assert_array_equal(got[2].numpy(), np.argsort(-score, kind="stable")[:k])
    assert int(got[1].sum()) == G


# --- the with_health kernel bodies, built with g++, against the plain
# versions --------------------------------------------------------------------


def _tsc(G, seed):
    return _t(np.random.default_rng(seed).integers(0, 70, size=G).astype(np.int32))


def _crashed_followers(st, P, G):
    """bool[P, G]: the peer after each group's leader down in every other
    group (the maximum commit runs over these rows too)."""
    crashed = torch.zeros((P, G), dtype=torch.bool)
    lead = st.state.eq(tk.ROLE_LEADER).to(torch.int64).argmax(0)
    idx = torch.arange(G)
    crashed[(lead + 1) % P, idx] = idx % 2 == 0
    return crashed


def _assert_health_outputs(want, got, plain, note):
    """want/got: a with_health variant's outputs (plain version, g++ body);
    plain: the with_health=False variant's, which must equal the rest."""
    assert len(want) == len(got) == len(plain) + 1
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, (note, i)
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{note} output {i}")
    for w, p in zip(want, plain):
        assert torch.equal(w, p), note
    assert want[-1].dtype == torch.int32 and tuple(want[-1].shape) == (want[0].shape[1],)


@needs_gxx
@pytest.mark.parametrize("P", [3, 5, 7])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_steady_health_body_matches_reference(P, k):
    G = 37
    for source, args in (("random", steady_tests._random_inputs(P, G, seed=P * 10 + k)),
                         ("settled", steady_tests._settled_inputs(P, G))):
        tsc = _tsc(G, k)
        for ticks in ((10, 1), (6, 3)):
            kw = dict(rounds=k, election_tick=ticks[0], heartbeat_tick=ticks[1])
            want = steady_rounds_reference(*args, tsc, **kw)
            got = steady_tests._host_rounds(args, k, *ticks, tsc=tsc)
            plain = steady_rounds_reference(*args, **kw)
            _assert_health_outputs(want, got, plain, f"steady {source} {ticks}")
            if source == "settled":  # commits flow: some groups reset to 0
                assert (want[-1] == 0).any()


@needs_gxx
@pytest.mark.parametrize("P", [3, 5, 7])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_chaos_health_body_matches_reference(P, k):
    G = 37
    cases = [("random", chaos_tests.random_inputs(P, G, seed=P * 10 + k), 2**31 - k, (6, 3))]
    if P != 7:
        for loss_kind, crashed in (("uniform", False), ("heavy", True)):
            cases.append((f"settled {loss_kind} crashed={crashed}",
                          chaos_tests.settled_inputs(P, G, loss_kind, crashed), 158, (60, 1)))
    for note, args, rb, ticks in cases:
        tsc = _tsc(G, k + 1)
        kw = dict(round_base=rb, rounds=k, election_tick=ticks[0], heartbeat_tick=ticks[1])
        want = chaos_rounds_reference(*args, tsc, **kw)
        got = chaos_tests._host_rounds(args, rb, k, *ticks, tsc=tsc)
        plain = chaos_rounds_reference(*args, **kw)
        _assert_health_outputs(want, got, plain, f"chaos {note}")


@needs_gxx
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("with_cq", [False, True])
@pytest.mark.parametrize("loss", [False, True])
def test_damped_health_body_matches_reference(P, with_cq, loss):
    G, k = 37, 32
    st = damped_tests.settled_port(G, P, "cq" if with_cq else "pv")
    lr = _t(damped_tests.loss_plane(P, G, 3)) if loss else None
    cases = [
        ("random", damped_tests.random_operands(P, G, P * 10 + with_cq, loss), (6, 3)),
        ("settled", fused_step.damped_operands(
            st, torch.zeros((P, G), dtype=torch.bool), torch.ones(G, dtype=torch.int32), lr),
         (10, 1)),
        ("settled, crashed followers", fused_step.damped_operands(
            st, _crashed_followers(st, P, G), torch.ones(G, dtype=torch.int32), lr),
         (10, 1)),
    ]
    for note, args, ticks in cases:
        tsc = _tsc(G, P + ticks[0])
        kw = dict(round_base=40, rounds=k, election_tick=ticks[0], heartbeat_tick=ticks[1],
                  with_cq=with_cq)
        want = damped_rounds_reference(*args, tsc, **kw)
        got = damped_tests._host_rounds(args, kw, tsc=tsc)
        plain = damped_rounds_reference(*args, **kw)
        _assert_health_outputs(want, got, plain, f"damped {note}")


@needs_gxx
@pytest.mark.parametrize("P", [1, 2, 4, 6])
def test_health_bodies_every_instantiated_peer_count(P):
    G, tsc = 19, _tsc(19, P)
    args = steady_tests._random_inputs(P, G, seed=P)
    kw = dict(rounds=5, election_tick=4, heartbeat_tick=2)
    _assert_health_outputs(steady_rounds_reference(*args, tsc, **kw),
                           steady_tests._host_rounds(args, 5, 4, 2, tsc=tsc),
                           steady_rounds_reference(*args, **kw), f"steady P={P}")
    args = chaos_tests.random_inputs(P, G, seed=P)
    kw = dict(round_base=1000, rounds=5, election_tick=4, heartbeat_tick=2)
    _assert_health_outputs(chaos_rounds_reference(*args, tsc, **kw),
                           chaos_tests._host_rounds(args, 1000, 5, 4, 2, tsc=tsc),
                           chaos_rounds_reference(*args, **kw), f"chaos P={P}")
    for with_cq in (False, True):
        for loss in (False, True):
            args = damped_tests.random_operands(P, G, P, loss)
            kw = dict(round_base=1000, rounds=5, election_tick=4, heartbeat_tick=2,
                      with_cq=with_cq)
            _assert_health_outputs(damped_rounds_reference(*args, tsc, **kw),
                                   damped_tests._host_rounds(args, kw, tsc=tsc),
                                   damped_rounds_reference(*args, **kw),
                                   f"damped P={P} cq={with_cq} loss={loss}")


def test_tsc_tracks_the_max_commit_over_every_row():
    """A follower that is crashed still counts in the max: a commit it holds
    above the leader's keeps the max flat, so tsc grows."""
    P, G = 3, 2
    args = list(steady_tests._settled_inputs(P, G))
    crashed = torch.zeros((P, G), dtype=torch.bool)
    lead = args[0].eq(tk.ROLE_LEADER).to(torch.int64).argmax(0)
    follower = (lead + 1) % P
    crashed[follower, torch.arange(G)] = True
    commit = args[7].clone()
    commit[follower, 0] = commit[:, 0].max() + 1000
    args[7], args[10] = commit, crashed
    tsc = torch.tensor([5, 5], dtype=torch.int32)
    out = steady_rounds_reference(*args, tsc, rounds=4, election_tick=10, heartbeat_tick=1)
    assert out[-1].tolist()[0] == 9  # the crashed row's commit holds the max
    assert out[-1].tolist()[1] == 0  # the leader's commit raised the max


@needs_gxx
def test_host_bodies_reject_health_without_its_pointers():
    null = ctypes.c_void_p(0)
    assert _build.load_steady_host().steady_round_host(
        *([null] * 21), 4, 3, 1, 10, 1, 1) != 0
    assert _build.load_chaos_host().chaos_round_host(
        *([null] * 27), 4, 3, 0, 1, 10, 1, 1) != 0


def test_wrappers_on_cpu_tensors_run_the_plain_health_versions():
    tsc = _tsc(16, 3)
    cases = (
        (steady_rounds, steady_rounds_reference, steady_tests._settled_inputs(3, 16),
         dict(rounds=4, election_tick=10, heartbeat_tick=1)),
        (chaos_rounds, chaos_rounds_reference, chaos_tests.random_inputs(3, 16, seed=9),
         dict(round_base=7, rounds=4, election_tick=10, heartbeat_tick=1)),
        (damped_rounds, damped_rounds_reference, damped_tests.random_operands(3, 16, 9, True),
         dict(round_base=7, rounds=4, election_tick=10, heartbeat_tick=1, with_cq=True)),
    )
    for fn, ref, args, kw in cases:
        before = (fn.launches, fn.health_launches)
        got = fn(*args, tsc, **kw)
        want = ref(*args, tsc, **kw)
        assert (fn.launches, fn.health_launches) == before
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert torch.equal(w, g)


def test_work_counts_with_health():
    P, G, k = 5, 100_000, 32
    nbytes, ops = health_work(P, G, k)
    # P - 1 imax for the first max, then P - 1 imax, compare, add and
    # select a round: 228 operations a group at P=5, k=32.
    assert nbytes == 8 * G and ops == ((P - 1) + (P + 2) * k) * G == 228 * G
    base, health = steady_work(P, G, k), steady_work(P, G, k, with_health=True)
    assert health == (base[0] + nbytes, base[1] + ops)
    assert chaos_tests.chaos_work(P, G, k, with_health=True)[1] == (
        chaos_tests.chaos_work(P, G, k)[1] + ops)
    assert damped_tests.damped_work(P, G, k, with_health=True)[1] == (
        damped_tests.damped_work(P, G, k)[1] + ops)
