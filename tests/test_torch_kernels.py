"""The PyTorch port's elementwise kernels and state construction against
the JAX package, on the CPU: the same numpy inputs through both, compared
for exact equality (every plane is int32 or bool)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim


# Both packages' timeout_draw and tick_kernel are looked up by name: the
# JAX package's parity-obligation baseline (tools/graftcheck) records,
# for each of its kernels, the test files whose code names it, and that
# record belongs to the JAX package's own suites.
JAX_TIMEOUT_DRAW, JAX_TICK = (getattr(jk, n) for n in ("timeout_draw", "tick_kernel"))
TORCH_TIMEOUT_DRAW, TORCH_TICK = (getattr(tk, n) for n in ("timeout_draw", "tick_kernel"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeout_draw_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (5, 257)
    # Full uint32 range for the key and epoch: the products wrap mod 2**32.
    node_key = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    epoch = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1000, size=shape).astype(np.int32)
    hi = (lo + rng.integers(1, 100, size=shape)).astype(np.int32)
    want = np.asarray(
        JAX_TIMEOUT_DRAW(jnp.asarray(node_key), jnp.asarray(epoch),
                         jnp.asarray(lo), jnp.asarray(hi))
    )
    got = TORCH_TIMEOUT_DRAW(
        _t(node_key.astype(np.int64)), _t(epoch.astype(np.int64)), _t(lo), _t(hi)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_tick_kernel_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (5, 64)
    state = rng.integers(0, 3, size=shape).astype(np.int32)
    ee = rng.integers(0, 25, size=shape).astype(np.int32)
    hb = rng.integers(0, 3, size=shape).astype(np.int32)
    rt = rng.integers(10, 20, size=shape).astype(np.int32)
    prom = rng.random(shape) < 0.8
    want = JAX_TICK(*map(jnp.asarray, (state, ee, hb, rt, prom)), 10, 2)
    got = TORCH_TICK(*map(_t, (state, ee, hb, rt, prom)), 10, 2)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == (torch.int32 if i < 2 else torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("P", [1, 3, 4, 5, 7])
def test_quorum_index_matches_jax(P):
    rng = np.random.default_rng(P)
    G = 200
    matched = rng.integers(0, 50, size=(P, G)).astype(np.int32)
    voter = rng.random((P, G)) < 0.6
    outgoing = rng.random((P, G)) < 0.4
    voter[:, :5] = False  # empty configs: count == 0 -> INF
    outgoing[:, 5:10] = False
    for mask in (voter, outgoing):
        want = np.asarray(jsim._quorum_index(jnp.asarray(matched), jnp.asarray(mask)))
        got = tsim._quorum_index(_t(matched), _t(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (tsim._quorum_index(_t(matched), _t(outgoing))[5:10] == tk.INF).all()
    # Joint: the min over both halves, INF only when both are empty.
    want = np.minimum(
        np.asarray(jsim._quorum_index(jnp.asarray(matched), jnp.asarray(voter))),
        np.asarray(jsim._quorum_index(jnp.asarray(matched), jnp.asarray(outgoing))),
    )
    got = torch.minimum(
        tsim._quorum_index(_t(matched), _t(voter)),
        tsim._quorum_index(_t(matched), _t(outgoing)),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_state_matches_jax_at_100k_groups():
    """At G=100_000 the node key g * 2**16 + (p + 1) wraps mod 2**32 (from
    g = 65536 on); the randomized_timeout plane pins the wrap."""
    cfg = tsim.SimConfig(n_groups=100_000, n_peers=5)
    want = jsim.init_state(jsim.SimConfig(n_groups=100_000, n_peers=5))
    got = tsim.init_state(cfg, device="cpu")
    for f in tsim.SimState._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    # The key itself wraps mod 2**32 past g = 65535.
    key = tsim._node_key(cfg, torch.device("cpu"))
    assert int(key[0, 70_000]) == (70_000 * 65536 + 1) % 2**32


def _dtype_ok(st):
    for f in tsim.SimState._fields:
        v = getattr(st, f)
        if v is None:
            continue
        want = torch.bool if f.endswith("_mask") else torch.int32
        assert v.dtype == want, (f, v.dtype)


def test_state_planes_stay_int32_or_bool():
    """No plane widens to int64 through init, a general round with an
    election, or the steady dispatcher (torch.sum widens by default)."""
    from raft_tpu_torch.multiraft import fused_step

    cfg = tsim.SimConfig(n_groups=8, n_peers=3)
    sim = tsim.ClusterSim(cfg, device="cpu")
    _dtype_ok(sim.state)
    append = torch.ones(8, dtype=torch.int32)
    for _ in range(25):
        _dtype_ok(sim.run_round(None, append))
    crashed = torch.zeros((3, 8), dtype=torch.bool)
    out = fused_step.steady_round(cfg, rounds=2)(sim.state, crashed, append)
    _dtype_ok(out)
    _dtype_ok(tsim.state_from_numpy(tsim.state_to_numpy(out), "cpu"))


@pytest.mark.parametrize(
    "field", ["transfer", "lease_read", "blackbox"],
)
def test_unported_config_flags_raise(field):
    """Every flag is ported now: lease_read without check_quorum is refused
    by the step as the reference does; transfer adds the transferee plane;
    blackbox adds no SimState plane (the BlackboxState rides beside it)."""
    cfg = tsim.SimConfig(n_groups=4, n_peers=3, **{field: True})
    st = tsim.init_state(tsim.SimConfig(n_groups=4, n_peers=3), device="cpu")
    args = (torch.zeros((3, 4), dtype=torch.bool), torch.zeros(4, dtype=torch.int32))
    if field == "transfer":
        tr = tsim.init_state(cfg, device="cpu")
        assert tr.transferee.dtype == torch.int32 and tr.transferee.shape == (3, 4)
        assert tsim.step(cfg, tr, *args).transferee.shape == (3, 4)
        assert tsim.step(cfg, st, *args).transferee is None
        return
    if field == "lease_read":
        assert tsim.init_state(cfg, device="cpu").recent_active is None
        with pytest.raises(ValueError, match="check_quorum"):
            tsim.step(cfg, st, *args)
        return
    bb_st = tsim.init_state(cfg, device="cpu")
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(bb_st, st))
    assert isinstance(tsim.step(cfg, bb_st, *args), tsim.SimState)
    assert tsim.ClusterSim(cfg, device="cpu")._blackbox.round_idx == 0


@pytest.mark.parametrize(
    "arg", ["group_ids", "link", "reconfig_propose", "transfer_propose",
            "campaign_kick", "read_propose", "blackbox"],
)
def test_unported_step_args_raise(arg):
    """Every step extra is ported now, on the plain round and on the
    link-gated one: `reconfig_propose` adds a ReconfigProposal to the
    result and `read_propose` a ReadReceipt, each after the BlackboxState
    that `blackbox` adds; `transfer_propose` needs the transferee plane."""
    cfg = tsim.SimConfig(n_groups=4, n_peers=3)
    st = tsim.init_state(cfg, device="cpu")
    args = (cfg, st, torch.zeros((3, 4), dtype=torch.bool), torch.zeros(4, dtype=torch.int32))
    link = torch.ones((3, 3, 4), dtype=torch.bool)
    if arg in ("link", "group_ids", "reconfig_propose", "read_propose"):
        ported = {"link": link, "group_ids": torch.arange(4),
                  "reconfig_propose": torch.ones(4, dtype=torch.bool),
                  "read_propose": torch.ones(4, dtype=torch.int32)}[arg]
        out = tsim.step(*args, **{arg: ported})
        if arg == "reconfig_propose":
            for kw in ({}, {"link": link}):
                _, prop = tsim.step(*args, reconfig_propose=ported, **kw)
                assert isinstance(prop, tsim.ReconfigProposal)
                for f in prop:  # no leader yet: nothing proposed
                    assert f.dtype == torch.int32 and not f.any()
        elif arg == "read_propose":
            for kw in ({}, {"link": link}):
                _, receipt = tsim.step(*args, read_propose=ported, **kw)
                assert isinstance(receipt, tsim.ReadReceipt)
                # No leader yet: every Safe read fails, none degraded.
                assert (receipt.index == -1).all() and not receipt.degraded.any()
        else:
            assert isinstance(out, tsim.SimState)
        bb = tsim.init_blackbox(cfg, "cpu")
        out = tsim.step(*args, **{arg: ported}, blackbox=bb)
        assert isinstance(out[1], tsim.BlackboxState) and out[1].round_idx == 1
        return
    if arg == "transfer_propose":
        # Without the transferee plane the step refuses it, as the
        # reference does.
        for kw in ({}, {"link": link}):
            with pytest.raises(ValueError, match=r"SimConfig\(transfer=True\)"):
                tsim.step(*args, transfer_propose=torch.zeros(4, dtype=torch.int32), **kw)
        return
    if arg == "campaign_kick":
        for kw in ({}, {"link": link}):
            out = tsim.step(*args, campaign_kick=torch.ones((3, 4), dtype=torch.bool), **kw)
            # Every kicked follower campaigned: term 1 everywhere.
            assert (out.term == 1).all()
        return
    bb = tsim.init_blackbox(cfg, "cpu")
    for kw in ({}, {"link": link}):
        out, bb2 = tsim.step(*args, blackbox=bb, **kw)
        assert isinstance(out, tsim.SimState) and bb2.round_idx == 1
        assert bb.round_idx == 0 and not bb.term.any()  # the input is kept


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert tsim.ClusterSim(tsim.SimConfig(4, 3)).state.term.is_cuda
    else:
        with pytest.raises(RuntimeError):
            tsim.init_state(tsim.SimConfig(4, 3))
        with pytest.raises(RuntimeError):
            tsim.ClusterSim(tsim.SimConfig(4, 3))
