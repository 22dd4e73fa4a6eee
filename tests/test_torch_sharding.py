"""The port's sharding.py against the JAX package's on the CPU: every
placement spec equal to the reference's PartitionSpec, the packed read-fire
fallback, shard-then-gather, and global_status on two gloo CPU ranks
(sharding.launch) against the reference's over a 2-device mesh of the
8-device virtual CPU platform, total_commit exact past 2**31.  The ranks
run raft_tpu_torch.tools.sharded_parity_report.replay, so they never import
the JAX package."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from raft_tpu.multiraft import sharding as jsh
from raft_tpu.multiraft import sim as jsim
from raft_tpu.multiraft import workload as jwl
from raft_tpu.multiraft.kernels import ROLE_LEADER
from raft_tpu_torch.multiraft import sharding as tsh
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl
from raft_tpu_torch.tools.sharded_parity_report import replay, replay_each

CPU2 = ["cpu", "cpu"]


def fake_mesh(rank: int, size: int = 2) -> tsh.Mesh:
    """A rank's Mesh without a process group: enough for the specs and
    the placement, which issue no collective."""
    return tsh.Mesh("groups", rank, size, torch.device("cpu"), "gloo")


def spec_of(jspec):
    return None if jspec is None else tuple(jspec.spec)


def test_state_specs_equal_reference_every_flag_combination():
    jmesh = jsh.make_mesh(2)
    mesh = fake_mesh(0)
    for damped in (False, True):
        for transfer in (False, True):
            want = jsh.state_sharding(jmesh, damped=damped, transfer=transfer)
            got = tsh.state_sharding(mesh, damped=damped, transfer=transfer)
            for name in tsim.SimState._fields:
                assert getattr(got, name) == spec_of(getattr(want, name)), (
                    damped, transfer, name)
    assert got.matched == (None, None, "groups") and got.term == (None, "groups")


def test_schedule_and_extra_specs_equal_reference():
    jmesh, mesh = jsh.make_mesh(2), fake_mesh(0)
    pairs = [
        (jsh.health_sharding(jmesh), tsh.health_sharding(mesh)),
        (jsh.blackbox_sharding(jmesh), tsh.blackbox_sharding(mesh)),
        (jsh.chaos_sharding(jmesh), tsh.chaos_sharding(mesh)),
        *zip(jsh.reconfig_sharding(jmesh), tsh.reconfig_sharding(mesh)),
        *zip(jsh.client_sharding(jmesh)[:2], tsh.client_sharding(mesh)[:2]),
    ]
    for want, got in pairs:
        assert type(want).__name__ == type(got).__name__
        assert want._fields == got._fields
        for name in want._fields:
            w = getattr(want, name)
            assert getattr(got, name) == (None if w is None else tuple(w.spec)), name
    assert tsh.client_sharding(mesh)[2] == tuple(jsh.client_sharding(jmesh)[2].spec)


@pytest.mark.parametrize("G,tiles", [(96, False), (128, True)])
def test_shard_client_packed_word_fallback(G, tiles):
    """The reference replicates the packed fire words when their count does
    not tile the mesh (G=96: 3 words on 2 devices) and shards them when it
    does (G=128); the port decides the same, and either way each rank
    unpacks exactly its own block of the whole batch's fire bits."""
    plan = twl.ClientPlan(name="edge", n_peers=3, phases=[
        twl.ClientPhase(rounds=4, read_every=2, read_mode="safe")])
    jplan = jwl.ClientPlan(name="edge", n_peers=3, phases=[
        jwl.ClientPhase(rounds=4, read_every=2, read_mode="safe")])
    jplaced, _ = jsh.shard_client(jwl.compile_plan(jplan, G), jwl.init_read_carry(G),
                                  jsh.make_mesh(2))
    assert (jplaced.read_fire_packed.sharding.spec == JP(None, "groups")) == tiles
    whole = twl.compile_plan(plan, G, "cpu")
    bits = twl.unpack_fires(whole.read_fire_packed, G)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(getattr(jwl.kernels, "unpack_bits_g")(jplaced.read_fire_packed, G)))
    cfg = tsim.SimConfig(G, 3)
    for rank in range(2):
        mesh = fake_mesh(rank)
        assert tsh.fire_words_tile(mesh, whole.read_fire_packed.shape[1], G) == tiles
        placed, rcar = tsh.shard_client(whole, twl.init_read_carry(G, "cpu"), mesh)
        words = placed.read_fire_packed
        assert words.shape[1] == (whole.read_fire_packed.shape[1] // 2 if tiles
                                  else whole.read_fire_packed.shape[1])
        lcfg = tsh.local_config(cfg, mesh)
        lo, hi = lcfg.shard.lo, lcfg.shard.hi
        assert rcar.pending_mode.shape == (hi - lo,)
        np.testing.assert_array_equal(
            twl.unpack_fires(words, hi - lo, lcfg).numpy(), bits[:, lo:hi].numpy())
        np.testing.assert_array_equal(placed.read_mode.numpy(),
                                      whole.read_mode[:, lo:hi].numpy())


def test_block_layout_and_tiling_refusal():
    assert [fake_mesh(r, 4).block(16) for r in range(4)] == [
        (0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError):
        fake_mesh(0).block(33)
    lcfg = tsh.local_config(tsim.SimConfig(32, 3), fake_mesh(1))
    assert (lcfg.n_groups, lcfg.shard.lo, lcfg.shard.hi, lcfg.shard.n_groups) == (16, 16, 32, 32)


def _random_state(G: int, P: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    st = {}
    for name in tsim.SimState._fields:
        shape = (P, P, G) if name in ("matched", "agree", "recent_active") else (P, G)
        if name in ("voter_mask", "outgoing_mask", "learner_mask", "recent_active"):
            st[name] = rng.rand(*shape) < 0.5
        else:
            st[name] = rng.randint(0, 1000, size=shape).astype(np.int32)
    return st


@pytest.fixture(scope="module")
def ranks_out():
    """One 2-rank launch for the module: shard-then-gather of a random
    damped, transfer-on state, and global_status on a 4096-group state
    whose leader commit sum passes 2**31."""
    G, big = 4096, 3_000_000
    status_state = jsim_state_to_numpy(G)
    status_state["state"][0] = ROLE_LEADER
    status_state["commit"][0] = big
    specs = [
        {"cfg": dict(n_groups=32, n_peers=3, check_quorum=True, transfer=True),
         "ops": [("set_state", _random_state(32, 3, 7))]},
        {"cfg": dict(n_groups=G, n_peers=3),
         "ops": [("set_state", status_state), ("status",)]},
    ]
    outs = tsh.launch(2, replay_each, specs, devices=CPU2)
    return specs, outs, status_state


def jsim_state_to_numpy(G: int) -> dict:
    st = jsim.init_state(jsim.SimConfig(n_groups=G, n_peers=3))
    return {f: np.array(getattr(st, f)) for f in jsim.SimState._fields
            if getattr(st, f) is not None}


def test_shard_then_gather_is_identity(ranks_out):
    specs, outs, _ = ranks_out
    want = specs[0]["ops"][0][1]
    got = outs[0]["state"]
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)


def test_global_status_equals_reference_past_int32(ranks_out):
    _, outs, arrays = ranks_out
    G = 4096
    jcfg = jsim.SimConfig(n_groups=G, n_peers=3)
    jmesh = jsh.make_mesh(2)
    st = jsim.SimState(**{f: (None if f not in arrays else np.asarray(arrays[f]))
                          for f in jsim.SimState._fields})
    want = jsh.global_status(jcfg, jmesh)(jsh.shard_state(st, jmesh))
    got = outs[1]["results"][1]
    assert got["total_commit"] == want["total_commit"] == G * 3_000_000 > 2**31
    for key in ("n_leaders", "min_commit", "max_term"):
        assert got[key] == int(want[key]), key
    assert got["n_leaders"] == G


def test_global_status_refuses_past_limb_range():
    with pytest.raises(ValueError):
        tsh.global_status(tsim.SimConfig(n_groups=8_500_000, n_peers=3), fake_mesh(0))


def test_mesh_entry_points_refuse_without_a_card():
    """make_mesh and launch place one rank per CUDA device by default and
    raise where there is none; CPU ranks only on request, and make_mesh only
    inside a launched rank."""
    if not torch.cuda.is_available():
        for call in (tsh.make_mesh, lambda: tsh.make_mesh(2),
                     lambda: tsh.launch(2, replay, {})):
            with pytest.raises(RuntimeError):
                call()
    with pytest.raises(RuntimeError):
        tsh.make_mesh(2, devices=CPU2)  # not inside a launched rank
    assert tsh.backend_for([torch.device("cpu")] * 2) == "gloo"
    assert tsh.backend_for([torch.device("cuda", 0)] * 2) == "gloo"
    assert tsh.backend_for([torch.device("cuda", 0), torch.device("cuda", 1)]) == "nccl"


def test_a_failing_rank_fails_the_launcher():
    with pytest.raises(RuntimeError, match="unknown operation"):
        tsh.launch(2, replay, {"cfg": dict(n_groups=8, n_peers=3), "ops": [("nope",)]},
                   devices=CPU2)
