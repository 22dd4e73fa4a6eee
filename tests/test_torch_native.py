"""The port's native C++ engine (raft_tpu_torch/multiraft/csrc/
multiraft_engine.cpp, built at -O3 into build/), ported from
test_native_engine.py: bit-for-bit against the port's ClusterSim on the CPU
on the same schedules, round by round, and against the JAX package's
NativeMultiRaft on the same schedule (the two engines' snapshots equal
every round)."""

import os

import numpy as np
import pytest
import torch

from raft_tpu.multiraft.native import NativeMultiRaft as RefNative
from raft_tpu_torch.multiraft import ClusterSim, SimConfig, _build
from raft_tpu_torch.multiraft.native import NativeMultiRaft

FIELDS = ("term", "state", "commit", "last_index", "last_term")


def compare(r, got, want, what):
    for f in FIELDS:
        if not np.array_equal(want[f], got[f]):
            bad = np.argwhere(want[f] != got[f])
            g, p = bad[0]
            raise AssertionError(
                f"round {r}: {f} mismatch at group {g} peer {p}: "
                f"{what}={want[f][g, p]} native={got[f][g, p]}"
            )


def sim_snapshot(sim):
    return {f: getattr(sim.state, f).cpu().numpy().astype(np.int32).T for f in FIELDS}


def run_parity(G, P, rounds, schedule, masks=None):
    """The port's engine, the port's ClusterSim and the reference engine
    on one schedule (crashed bool[G, P], append int[G] a round); `masks`
    (voter, outgoing, learner) uint8[G, P] config masks for all three."""
    native, ref = NativeMultiRaft(G, P), RefNative(G, P)
    sim_masks = ()
    if masks is not None:
        native.set_config(*masks)
        ref.set_config(*masks)
        sim_masks = tuple(torch.from_numpy(m.T != 0) for m in masks)
    sim = ClusterSim(SimConfig(n_groups=G, n_peers=P), *sim_masks, device="cpu")
    for r in range(rounds):
        crashed, append = schedule(r)
        native.step(crashed, append)
        ref.step(crashed, append)
        sim.run_round(torch.from_numpy(np.ascontiguousarray(crashed.T)),
                      torch.from_numpy(np.asarray(append, np.int32)))
        got = native.snapshot()
        compare(r, got, sim_snapshot(sim), "device")
        compare(r, got, ref.snapshot(), "reference-native")


def test_native_builds_optimised_into_build():
    """The library is the -O3 build of the port's own source, in build/."""
    lib = _build.load_native_engine()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libmultiraft_engine-")
    assert "-O3" in _build.NATIVE_FLAGS


def test_native_quiet_and_appends():
    G, P = 8, 3

    def schedule(r):
        return np.zeros((G, P), bool), np.full(G, int(r % 2), np.int64)

    run_parity(G, P, 60, schedule)


def test_native_crash_recovery():
    G, P = 4, 5

    def schedule(r):
        crashed = np.zeros((G, P), bool)
        if 25 <= r < 60:
            crashed[:, 0] = True
        if 80 <= r < 120:
            crashed[:, :3] = True  # majority outage
        return crashed, np.full(G, 1, np.int64)

    run_parity(G, P, 140, schedule)


@pytest.mark.parametrize("seed", range(4))
def test_native_random_schedules(seed):
    G, P = 4, 3
    rng = np.random.RandomState(seed + 100)
    crashed = np.zeros((G, P), bool)

    def schedule(r):
        for g in range(G):
            for p in range(P):
                if rng.rand() < 0.02:
                    crashed[g, p] = not crashed[g, p]
        return crashed.copy(), rng.randint(0, 3, size=G).astype(np.int64)

    run_parity(G, P, 80, schedule)


def test_native_run_batch():
    """mr_run advances many rounds without crossing the FFI per round, and
    lands where the reference engine does."""
    G, P = 16, 5
    native, ref = NativeMultiRaft(G, P), RefNative(G, P)
    native.run(50, None, np.ones(G, np.int32))
    ref.run(50, None, np.ones(G, np.int32))
    snap = native.snapshot()
    # All groups elected and committed (noop + 1/round in steady state).
    assert (snap["commit"].max(axis=1) > 0).all()
    assert ((snap["state"] == 2).sum(axis=1) == 1).all()
    compare(50, snap, ref.snapshot(), "reference-native")


def test_native_read_index_matches_the_reference():
    G, P = 16, 5
    native, ref = NativeMultiRaft(G, P), RefNative(G, P)
    crashed = np.zeros((G, P), bool)
    crashed[::3, 0] = True
    for eng in (native, ref):
        eng.run(40, crashed, np.ones(G, np.int32))
    np.testing.assert_array_equal(native.read_index(), ref.read_index())
    np.testing.assert_array_equal(native.read_index(crashed), ref.read_index(crashed))
    assert (native.read_index() >= 0).any()


def config_schedule(G, P, seed):
    rng = np.random.RandomState(seed)
    crashed = np.zeros((G, P), bool)

    def schedule(r):
        for g in range(G):
            if rng.rand() < 0.05:
                p = rng.randint(P)
                crashed[g, p] = not crashed[g, p]
            if crashed[g].sum() == P:
                crashed[g, rng.randint(P)] = False
        return crashed.copy(), rng.randint(0, 2, size=G).astype(np.int64)

    return schedule


def masks_of(G, P, voters, outgoing, learners):
    out = []
    for ids in (voters, outgoing, learners):
        m = np.zeros((G, P), np.uint8)
        for id in ids:
            m[:, id - 1] = 1
        out.append(m)
    return tuple(out)


def test_native_joint_config_parity():
    G, P = 4, 5
    run_parity(G, P, 100, config_schedule(G, P, 31),
               masks_of(G, P, [1, 2, 3], [3, 4, 5], []))


def test_native_learner_config_parity():
    G, P = 4, 5
    run_parity(G, P, 100, config_schedule(G, P, 32),
               masks_of(G, P, [1, 2, 3], [], [4, 5]))
