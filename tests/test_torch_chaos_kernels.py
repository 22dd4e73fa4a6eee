"""The chaos slice's kernels on the CPU: the port's link_loss_draw against
the JAX package's, and the CUDA kernel's body (csrc/chaos_body.cuh) built
for the host with g++ and held bit-identical to its plain PyTorch version
(chaos_rounds_reference), the only way to check the kernel's arithmetic
without a card.  Inputs are random planes (any roles, several or no
leaders, crashes, masks and loss rates, so every branch of the body is
taken), planes with exactly 0, 1 or 3 acting leaders a group (each arm of
the body's loss draws and carried agreement row), and lossy-settled
states, at ragged G, at every instantiated P, in both storages of the
agree block (the plain array and the CUDA build's shared-memory column)
and at group bases 0 and 8,300,000; the leader arms also meet the JAX
package's Pallas chaos kernel in interpret mode.  The tolerance is exact
equality (every plane is int32 or bool)."""

import ctypes
import functools
import shutil
import sys
from pathlib import Path

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
from raft_tpu_torch.multiraft import sim
from raft_tpu_torch.multiraft.chaos_kernel import (
    MAX_PEERS,
    OUTPUT_NAMES,
    chaos_body_work,
    chaos_rounds,
    chaos_rounds_reference,
    chaos_work,
)

from test_torch_damped_kernels import MESH_BASE, place_leaders, to_jax
from test_torch_sim import assert_states_equal
from test_torch_sim_fuzz import random_state

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ is needed to build the host shim"
)

# Both packages' link_loss_draw are looked up by name: the JAX package's
# parity-obligation baseline records, for each of its kernels, the test
# files whose code names it.
JAX_LOSS_DRAW, TORCH_LOSS_DRAW = (getattr(m, "link_loss_draw") for m in (jk, tk))


@pytest.mark.parametrize("P", [3, 5, 7])
@pytest.mark.parametrize("round_idx", [0, 1, 150, 2**31 - 1])
@pytest.mark.parametrize("with_ids", [False, True])
def test_link_loss_draw_matches_jax(P, round_idx, with_ids):
    rng = np.random.default_rng(P * 7 + round_idx % 97)
    G = 301
    loss = rng.integers(0, tk.LOSS_SCALE + 1, size=(P, P, G)).astype(np.int32)
    loss[:, :, :5] = 0
    loss[:, :, 5:10] = tk.LOSS_SCALE
    ids = rng.integers(0, 2**31, size=G).astype(np.int32) if with_ids else None
    want = np.asarray(JAX_LOSS_DRAW(
        jnp.int32(round_idx), jnp.asarray(loss),
        None if ids is None else jnp.asarray(ids),
    ))
    got = TORCH_LOSS_DRAW(
        round_idx, torch.from_numpy(loss),
        None if ids is None else torch.from_numpy(ids),
    )
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[:, :, :5].any() and want[:, :, 5:10].all()


def _host_rounds(args, round_base, rounds, election_tick, heartbeat_tick,
                 tsc=None):
    """The g++ build of the body; with `tsc`, its with_health instance,
    tsc' appended to the outputs."""
    lib = _build.load_chaos_host()
    P, G = args[0].shape
    args = [a.contiguous() for a in args]
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((P, P, G), dtype=torch.int32))
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = lib.chaos_round_host(
        *[t.data_ptr() for t in (*args, *outs)],
        *[None if t is None else t.data_ptr() for t in (tsc, tsc_out)],
        G, P, round_base, rounds, election_tick, heartbeat_tick,
        int(tsc is not None),
    )
    assert rc == 0
    return outs + ([] if tsc is None else [tsc_out])


def random_inputs(P, G, seed):
    """Random operand planes, small enough that no int32 sum wraps."""
    rng = np.random.default_rng(seed)

    def ints(hi, shape=(P, G)):
        return torch.from_numpy(rng.integers(0, hi, size=shape).astype(np.int32))

    def bools(p):
        return torch.from_numpy(rng.random((P, G)) < p)

    loss = rng.integers(0, tk.LOSS_SCALE + 1, size=(P, P, G))
    loss = np.where(rng.random((P, P, G)) < 0.5, loss // 20, loss).astype(np.int32)
    return (
        ints(3), ints(P + 1), ints(3), ints(12), ints(40), ints(5), ints(40),
        ints(40), bools(0.8), bools(0.9), bools(0.2), ints(40, (P, P, G)),
        torch.from_numpy(loss), ints(40, (G,)), ints(5, (G,)), ints(3, (G,)),
    )


def settled_inputs(P, G, loss_kind, crashed_followers):
    """The operands fused_step.chaos_round gathers from a state that
    settled 150 rounds and then ran 8 lossy linked rounds."""
    cfg = sim.SimConfig(n_groups=G, n_peers=P, election_tick=60)
    s = sim.ClusterSim(cfg, device="cpu")
    append = torch.ones(G, dtype=torch.int32)
    s.run(150, None, append)
    loss = heavy_loss(P, G) if loss_kind == "heavy" else torch.full((P, P, G), 100, dtype=torch.int32)
    link = torch.ones((P, P, G), dtype=torch.bool)
    for r in range(8):
        s.run_round(None, append, link=link & ~TORCH_LOSS_DRAW(150 + r, loss))
    st = s.state
    crashed = torch.zeros((P, G), dtype=torch.bool)
    if crashed_followers:
        lead = st.state.eq(2).to(torch.int64).argmax(0)
        idx = torch.arange(G)
        crashed[(lead + 1) % P, idx] = idx % 3 == 0
    return fused_step.chaos_operands(st, crashed, append, loss)


def heavy_loss(P, G):
    """tests/test_pallas_step.py:_loss_plane's layout."""
    loss = torch.zeros((P, P, G), dtype=torch.int32)
    loss[0, 1, :] = 3000
    loss[1, 0, ::2] = 5000
    loss[(P - 1) % P, P // 2, 1::3] = 7000
    return loss


def assert_host_matches(args, round_base, k, ticks):
    want = chaos_rounds_reference(
        *args, round_base=round_base, rounds=k, election_tick=ticks[0],
        heartbeat_tick=ticks[1],
    )
    got = _host_rounds(args, round_base, k, *ticks)
    for name, w, g in zip(OUTPUT_NAMES, want, got):
        assert w.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name} {ticks}")
    return want


@needs_gxx
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_host_body_matches_reference_on_random_planes(P, k):
    args = random_inputs(P, 37, seed=P * 100 + k)  # 37: not a block multiple
    for round_base, ticks in ((150, (60, 1)), (2**31 - k, (6, 3)), (0, (3, 2))):
        assert_host_matches(args, round_base, k, ticks)


@needs_gxx
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("loss_kind,crashed", [("uniform", False), ("heavy", True)])
def test_host_body_matches_reference_on_settled_planes(P, k, loss_kind, crashed):
    args = settled_inputs(P, 37, loss_kind, crashed)
    want = assert_host_matches(args, 158, k, (60, 1))
    # The settled state keeps committing, and commit never goes back.
    before, after = args[6].amax(0), want[6].amax(0)
    assert (after >= before).all() and (after > before).any()


@needs_gxx
@pytest.mark.parametrize("P", [1, 2, 4, 6, 7])
def test_host_body_every_instantiated_peer_count(P):
    args = random_inputs(P, 19, seed=P)
    assert_host_matches(args, 1000, 5, (4, 2))


@needs_gxx
def test_host_body_rejects_unsupported_peer_count():
    lib = _build.load_chaos_host()
    null = ctypes.c_void_p(0)
    assert lib.chaos_round_host(*([null] * 27), 4, 8, 0, 1, 10, 1, 0) != 0


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    args = random_inputs(3, 16, seed=9)
    kw = dict(round_base=7, rounds=4, election_tick=10, heartbeat_tick=1)
    before = chaos_rounds.launches
    got = chaos_rounds(*args, **kw)
    want = chaos_rounds_reference(*args, **kw)
    assert chaos_rounds.launches == before
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError):
        chaos_rounds(*args, **{**kw, "round_base": 2**31 - 3})


def test_chaos_work_counts():
    nbytes, ops = chaos_work(5, 100_000, 32)
    # 8 int32 + 3 one-byte [P, G] planes, agree, the leader's 8 loss
    # rates, 3 rows in; 8 int32 planes and agree out.
    assert nbytes == (35 * 5 + 4 * 25 + 4 * 8 + 32 * 5 + 4 * 25) * 100_000 + 12 * 100_000
    # 1,573 operations a group-round with all 25 draws; 1,289 with the 8
    # the outputs read.
    assert ops == (20 * 25 + 120 * 5 + 12 * 8 + 6 * 10 + 33) * 32 * 100_000
    assert ops == 1289 * 32 * 100_000


def test_check_operands_rejects_what_the_kernels_cannot_take():
    """The wrappers' guard before handing raw pointers to a kernel: wrong
    dtype, shape or device, or a strided view, raises."""
    from raft_tpu_torch.multiraft.platform import check_operands

    cpu = torch.device("cpu")
    good = torch.zeros((3, 8), dtype=torch.int32)
    check_operands("k", cpu, (({"x": good}, (3, 8), torch.int32),))
    for bad in (good.to(torch.int64), good[:, :4], good.t().contiguous().t()):
        with pytest.raises(ValueError):
            check_operands("k", cpu, (({"x": bad}, (3, 8), torch.int32),))
    with pytest.raises(ValueError):
        check_operands("k", torch.device("meta"), (({"x": good}, (3, 8), torch.int32),))


def test_chaos_body_work_counts():
    """The body's count: the plain version's bytes, fewer operations."""
    nbytes, ops = chaos_body_work(5, 100_000, 32)
    assert nbytes == chaos_work(5, 100_000, 32)[0]
    # 729 operations a group-round at P=5: 2P² + 121P + 6 × 10
    # comparators + 14; 129 once a group (P² + 20P + P - 1).
    assert ops == (729 * 32 + 129) * 100_000
    # P=8: 28 comparators, 1,278 a group-round, 231 once.
    assert chaos_body_work(8, 10, 1)[1] == (1278 + 231) * 10
    # with_health adds health_work's count, as chaos_work does.
    h = chaos_body_work(5, 10, 8, with_health=True)[1] - chaos_body_work(5, 10, 8)[1]
    assert h == chaos_work(5, 10, 8, with_health=True)[1] - chaos_work(5, 10, 8)[1]
    assert chaos_body_work(5, 10, 8, with_health=True)[0] == chaos_work(
        5, 10, 8, with_health=True)[0]
    for P in range(1, MAX_PEERS + 1):
        for health in (False, True):
            assert chaos_body_work(P, 7, 8, health)[1] < chaos_work(P, 7, 8, health)[1]


# --- both storages of the agree block, every P, the leader arms ------------


def _host_at(args, kw, tsc, strided):
    """chaos_round_host_at (the body over a plain array) or, `strided`,
    chaos_round_host_strided_at (over the CUDA build's shared-memory
    layout), from the narrow or the wide library by P."""
    P, G = args[0].shape
    lib = _build.load_chaos_host(P)
    fn = lib.chaos_round_host_strided_at if strided else lib.chaos_round_host_at
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((P, P, G), dtype=torch.int32))
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = fn(
        *[a.contiguous().data_ptr() for a in args],
        *[t.data_ptr() for t in outs],
        *[None if t is None else t.data_ptr() for t in (tsc, tsc_out)],
        G, P, kw["round_base"], kw["rounds"], kw["election_tick"],
        kw["heartbeat_tick"], int(tsc is not None), kw["group_base"],
    )
    assert rc == 0
    return outs + ([] if tsc is None else [tsc_out])


def assert_layouts_match(args, kw):
    """Both storages of the g++ body, both health variants, equal to the
    plain version; returns the plain version's outputs without health."""
    G = args[0].shape[1]
    tsc = torch.from_numpy(np.random.default_rng(G).integers(0, 100, size=G).astype(np.int32))
    for t in (tsc, None):
        want = chaos_rounds_reference(*args, t, **kw)
        for strided in (False, True):
            got = _host_at(args, kw, t, strided)
            for name, w, g in zip(OUTPUT_NAMES + ("tsc",), want, got):
                assert w.dtype == g.dtype, name
                np.testing.assert_array_equal(
                    g.numpy(), w.numpy(),
                    err_msg=f"{name} strided={strided} health={t is not None} {kw}")
    return want


def settled_small(P, G):
    """The operands chaos_round gathers from a state settled 40 rounds at
    election_tick 10, then 4 linked rounds under 5 % loss; the operands'
    own loss plane is 5 % everywhere."""
    cfg = sim.SimConfig(n_groups=G, n_peers=P, election_tick=10)
    s = sim.ClusterSim(cfg, device="cpu")
    append = torch.ones(G, dtype=torch.int32)
    s.run(40, None, append)
    loss = torch.full((P, P, G), 500, dtype=torch.int32)
    link = torch.ones((P, P, G), dtype=torch.bool)
    for r in range(4):
        s.run_round(None, append, link=link & ~TORCH_LOSS_DRAW(40 + r, loss))
    return fused_step.chaos_operands(s.state, torch.zeros((P, G), dtype=torch.bool),
                                     append, loss)


@needs_gxx
@pytest.mark.parametrize("P", range(1, MAX_PEERS + 1))
def test_host_body_both_layouts_every_peer_count(P):
    """Random planes at group bases 0 and 8,300,000 and a settled state at
    every instantiated P (1..7 from the narrow library, 8..15 from the wide
    one), in both storages of the agree block, with_health off and on."""
    args = random_inputs(P, 13, seed=500 + P)
    for base in (0, MESH_BASE):
        assert_layouts_match(args, dict(round_base=2**31 - 16, rounds=16, election_tick=6,
                                        heartbeat_tick=1, group_base=base))
    args = settled_small(P, 13)
    want = assert_layouts_match(args, dict(round_base=44, rounds=16, election_tick=10,
                                           heartbeat_tick=1, group_base=MESH_BASE))
    # The settled groups keep committing, and commit never goes back.
    before, after = args[6].amax(0), want[6].amax(0)
    assert (after >= before).all() and (after > before).any()


def leader_inputs(P, G, n_leaders, seed, slot=None):
    """random_inputs with exactly `n_leaders` acting leaders in every group
    (or one at `slot`), as place_leaders sets them."""
    args = list(random_inputs(P, G, seed))
    args[0], args[10] = place_leaders(P, G, n_leaders, seed + 1, slot)
    return tuple(args)


def assert_draws_gate(args, kw, want):
    """The loss draws change some output: the plain version without loss
    differs from `want`."""
    dry = chaos_rounds_reference(*args[:12], torch.zeros_like(args[12]), *args[13:], **kw)
    assert any(not torch.equal(w, d) for w, d in zip(want, dry))


@needs_gxx
@pytest.mark.parametrize("P", [2, 5, 8, 13, 14, 15])
@pytest.mark.parametrize("n_leaders", [0, 1, 3])
@pytest.mark.parametrize("group_base", [0, MESH_BASE])
def test_host_body_leader_arms(P, n_leaders, group_base):
    """0, 1 and 3 acting leaders (2 at P = 2): no draw, the leader's row and
    column rates from registers, and each leader's links from the plane;
    P = 13 and 14 are the two sides of the CUDA build's layout switch."""
    n = min(n_leaders, P)
    args = leader_inputs(P, 13, n, 1000 * P + 10 * n)
    kw = dict(round_base=2**31 - 16, rounds=16, election_tick=6, heartbeat_tick=1,
              group_base=group_base)
    want = assert_layouts_match(args, kw)
    if n and P >= 5:  # the draws gate something (at P = 2 they may not)
        assert_draws_gate(args, kw, want)


@needs_gxx
@pytest.mark.parametrize("P", [5, 15])
@pytest.mark.parametrize("slot", ["first", "last"])
def test_host_body_single_leader_at_either_end(P, slot):
    """One acting leader at slot 0 or P - 1 in every group: the leader's
    row and column rates, and its draw lanes, at the ends of the block."""
    where = 0 if slot == "first" else P - 1
    args = leader_inputs(P, 13, 1, 7 * P + where, slot=where)
    for group_base in (0, MESH_BASE):
        kw = dict(round_base=40, rounds=16, election_tick=6, heartbeat_tick=1,
                  group_base=group_base)
        assert_draws_gate(args, kw, assert_layouts_match(args, kw))


@needs_gxx
@pytest.mark.parametrize("P", [5, 8])
def test_host_body_leaders_summed_row_wraps(P):
    """Three acting leaders whose agree rows sum past 2**31: the carried
    row, three times the row every leader holds after an event, wraps in
    int32 as the reference's sum does."""
    args = list(leader_inputs(P, 13, 3, 60 + P))
    args[11] = args[11] + 2**30  # each row about 1.07e9, the sum negative
    args[4] = args[4] + 2**30  # the log indices the events write, as large
    kw = dict(round_base=9, rounds=16, election_tick=6, heartbeat_tick=1, group_base=0)
    want = assert_layouts_match(tuple(args), kw)
    assert (want[8] < 0).any() and (want[8] > 2**30).any()


@needs_gxx
@pytest.mark.parametrize("n_leaders", [1, 3])
def test_host_body_rates_outside_the_scale(n_leaders):
    """Loss rates below 0 (never drop) and above 10,000 (always drop), down
    to int32's ends: the lone leader's held rates and the several-leader
    arm's rates read from the plane compare as the reference's do."""
    P, G = 5, 13
    args = list(leader_inputs(P, G, n_leaders, 70 + n_leaders))
    rng = np.random.default_rng(n_leaders)
    args[12] = torch.from_numpy(rng.choice(
        np.array([-2**31, -1, 0, 1, 9999, 10_000, 10_001, 2**31 - 1], np.int32),
        size=(P, P, G)))
    kw = dict(round_base=5, rounds=16, election_tick=6, heartbeat_tick=1, group_base=0)
    assert_draws_gate(tuple(args), kw, assert_layouts_match(tuple(args), kw))


@functools.lru_cache(maxsize=None)
def _pallas_chaos(G, P, k):
    jcfg = jsim.SimConfig(n_groups=G, n_peers=P, election_tick=10)
    return jax.jit(jps.steady_round(jcfg, rounds=k, with_chaos=True, interpret=True))


@needs_gxx
@pytest.mark.parametrize("n_leaders, slot", [(0, None), (1, None), (3, None), (1, 4)])
def test_leader_arms_match_pallas(n_leaders, slot):
    """Random states at P = 5 with exactly 0, 1 or 3 acting leaders (or one
    at slot P - 1 in every group): the port's chaos round against the
    Pallas kernel in interpret mode, and the g++ body, both storages, on
    the same operands against the plain version, so each arm of the body
    meets the JAX package on one input."""
    P, G, rb, k = 5, 16, 2**31 - 4, 4
    st = sim.state_from_numpy(random_state(P, G, 80 + n_leaders), "cpu")
    state, crashed = place_leaders(P, G, n_leaders, 90 + n_leaders, slot)
    st = st._replace(state=state)
    tcfg = sim.SimConfig(n_groups=G, n_peers=P, election_tick=10)
    append = torch.ones(G, dtype=torch.int32)
    append[::4] = 0
    rng = np.random.default_rng(n_leaders)
    loss = rng.integers(0, 4000, size=(P, P, G)).astype(np.int32)
    loss[:, :, ::3] = 0
    loss = torch.from_numpy(loss)
    want = _pallas_chaos(G, P, k)(
        to_jax(st), jnp.asarray(crashed.numpy()), jnp.asarray(append.numpy()),
        jnp.asarray(loss.numpy()), jnp.int32(rb))
    got = fused_step.chaos_round(tcfg, rounds=k)(st, crashed, append, loss, rb)
    assert_states_equal(want, got, f"{n_leaders} acting leaders")
    assert not torch.equal(got.commit, st.commit) or n_leaders == 0
    args = fused_step.chaos_operands(st, crashed, append, loss)
    kw = dict(round_base=rb, rounds=k, election_tick=tcfg.election_tick,
              heartbeat_tick=tcfg.heartbeat_tick, group_base=0)
    want = assert_layouts_match(args, kw)
    if n_leaders:
        assert_draws_gate(args, kw, want)


def test_timing_tool_variants_rewrite_both_kernels(tmp_path):
    """raft_tpu_torch/tools/damped_kernel_times.py --variant: the copy of
    csrc/ it builds from has the shape constants rewritten in the chosen
    kernel's wrapper (the steady warp body's half-warp width in its
    header), or the steady warp body's one-leader tests made false
    (select=rounds), and nothing else changed."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "raft_tpu_torch" / "tools"))
    try:
        import damped_kernel_times as tool
    finally:
        sys.path.pop(0)
    for kernel, variants in (("chaos", {"agree": "shared", "min_blocks": "2"}),
                             ("damped", {"agree": "shared", "min_blocks": "2"}),
                             ("steady", {"half_warp": "0"})):
        out = tool.variant_csrc(tmp_path, _build.CSRC, kernel, variants)
        for key, value in variants.items():
            name, head = tool.SHAPE_CONSTANTS[key]
            src = (out / name.format(kernel=kernel)).read_text()
            want = tool.PLACES[value] if key == "agree" else value
            assert src.count(head + " = ") == 1
            assert f"{head} = {want};" in src
        assert (out / "chaos_body.cuh").read_text() == (_build.CSRC / "chaos_body.cuh").read_text()
    out = tool.variant_csrc(tmp_path, _build.CSRC, "steady", {"select": "rounds"})
    orig = (_build.CSRC / "steady_warp_body.cuh").read_text()
    body = (out / "steady_warp_body.cuh").read_text()
    assert orig.count("n_lead == 1") == 2 and "n_lead == 1" not in body
    assert body == orig.replace("n_lead == 1", "false")
    assert (out / "steady_round_warp.cu").read_text() == (
        _build.CSRC / "steady_round_warp.cu").read_text()
    assert set(tool.ROWS) == {"chaos", "damped", "steady"}
