"""The chaos slice's kernels on the CPU: the port's link_loss_draw against
the JAX package's, and the CUDA kernel's body (csrc/chaos_body.cuh) built
for the host with g++ and held bit-identical to its plain PyTorch version
(chaos_rounds_reference), the only way to check the kernel's arithmetic
without a card.  Inputs are random planes (any roles, several or no
leaders, crashes, masks and loss rates, so every branch of the body is
taken) and lossy-settled states, at ragged G; the tolerance is exact
equality (every plane is int32 or bool)."""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu_torch.multiraft import _build, fused_step
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim
from raft_tpu_torch.multiraft.chaos_kernel import (
    OUTPUT_NAMES,
    chaos_rounds,
    chaos_rounds_reference,
    chaos_work,
)

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
