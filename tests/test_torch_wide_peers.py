"""The fused kernels at P = 8..15 (csrc/*_round_wide.cu's bodies, built with
g++ from csrc/*_host_wide.cpp) held to their plain versions on random
planes at P = 8, 11 and 15, in every flag variant (steady with_health;
chaos with_health; damped with_cq, with_loss, with_health), and the steady
kernel's runtime-P instance at P = 16 and at its cap.  Past P = 15 the
chaos and damped rounds refuse the config, as the reference's builders
assert P <= 15; the steady path has no such limit in the reference and
takes P up to steady_kernel.MAX_PEERS here.  Exact.

The port's fast_multi_round at P = 8 and 16 against raft_tpu's, with the
Pallas kernel in interpret mode, is in test_torch_wide_peers_slice.py."""

import shutil

import numpy as np
import pytest
import torch

from raft_tpu_torch.multiraft import _build, fused_step
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import steady_kernel
from raft_tpu_torch.multiraft.chaos_kernel import (
    MAX_PEERS, OUTPUT_NAMES as CHAOS_OUTPUTS, chaos_rounds_reference)
from raft_tpu_torch.multiraft.damped_kernel import (
    OUTPUT_NAMES as DAMPED_OUTPUTS, damped_rounds_reference)
from raft_tpu_torch.multiraft.steady_kernel import steady_rounds_reference

import test_torch_chaos_kernels as chaos_tests
import test_torch_damped_kernels as damped_tests
import test_torch_kernel_body as steady_tests

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is needed to build the host shim")

WIDE = (8, 11, 15)
G = 13
STEADY_OUTPUTS = ("ee", "hb", "li", "lt", "matched", "commit")


def tsc_row(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 100, size=G).astype(np.int32))


def ptrs(tensors):
    return [None if t is None else t.contiguous().data_ptr() for t in tensors]


def steady_host(args, tsc, wide=None, **kw):
    P = args[0].shape[0]
    lib = P if wide is None else (8 if wide else 1)  # the library's peer count
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(6)]
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = _build.load_steady_host(lib).steady_round_host(
        *ptrs(args), *ptrs(outs), *ptrs((tsc, tsc_out)), G, P, kw["rounds"],
        kw["election_tick"], kw["heartbeat_tick"], int(tsc is not None))
    return rc, outs + ([] if tsc is None else [tsc_out])


def chaos_host(args, tsc, wide=None, **kw):
    P = args[0].shape[0]
    lib = P if wide is None else (8 if wide else 1)  # the library's peer count
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(8)]
    outs.append(torch.empty((P, P, G), dtype=torch.int32))
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = _build.load_chaos_host(lib).chaos_round_host(
        *ptrs(args), *ptrs(outs), *ptrs((tsc, tsc_out)), G, P, kw["round_base"],
        kw["rounds"], kw["election_tick"], kw["heartbeat_tick"], int(tsc is not None))
    return rc, outs + ([] if tsc is None else [tsc_out])


def damped_host(args, tsc, wide=None, **kw):
    P = args[0].shape[0]
    lib = P if wide is None else (8 if wide else 1)  # the library's peer count
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(8)]
    outs += [torch.empty((P, G), dtype=torch.bool), torch.empty((P, P, G), dtype=torch.int32)]
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = _build.load_damped_host(lib).damped_round_host(
        *ptrs(args), *ptrs(outs), *ptrs((tsc, tsc_out)), G, P, kw["round_base"],
        kw["rounds"], kw["election_tick"], kw["heartbeat_tick"], int(kw["with_cq"]),
        int(args[13] is not None), int(tsc is not None))
    return rc, outs + ([] if tsc is None else [tsc_out])


def assert_host_equals_plain(host, reference, names, args, kw, seed):
    for tsc in (None, tsc_row(seed)):
        full = args + (tsc,)
        want = reference(*full, **kw)
        rc, got = host(args, tsc, **kw)
        assert rc == 0
        assert len(got) == len(want)
        for name, w, g in zip(names + ("tsc",), want, got):
            assert g.dtype == w.dtype, name
            assert torch.equal(g, w), f"{name} with_health={tsc is not None}"


@needs_gxx
@pytest.mark.parametrize("P", WIDE + (16, steady_kernel.MAX_PEERS))
def test_steady_host_equals_plain(P):
    args = steady_tests._random_inputs(P, G, seed=P)
    assert_host_equals_plain(steady_host, steady_rounds_reference, STEADY_OUTPUTS,
                             args, dict(rounds=32, election_tick=10, heartbeat_tick=1),
                             seed=P)


@needs_gxx
def test_steady_host_settled_p8():
    args = steady_tests._settled_inputs(8, G)
    assert_host_equals_plain(steady_host, steady_rounds_reference, STEADY_OUTPUTS,
                             args, dict(rounds=32, election_tick=10, heartbeat_tick=1),
                             seed=1)


@needs_gxx
@pytest.mark.parametrize("P", WIDE)
@pytest.mark.parametrize("round_base", [7, 2**31 - 32])
def test_chaos_host_equals_plain(P, round_base):
    args = chaos_tests.random_inputs(P, G, seed=10 + P)
    assert_host_equals_plain(
        chaos_host, chaos_rounds_reference, CHAOS_OUTPUTS, args,
        dict(round_base=round_base, rounds=32, election_tick=6, heartbeat_tick=1),
        seed=P)


@needs_gxx
@pytest.mark.parametrize("P", WIDE)
@pytest.mark.parametrize("with_cq", [False, True])
@pytest.mark.parametrize("loss", [False, True])
def test_damped_host_equals_plain(P, with_cq, loss):
    args = damped_tests.random_operands(P, G, 20 + P, loss)
    assert_host_equals_plain(
        damped_host, damped_rounds_reference, DAMPED_OUTPUTS, args,
        dict(round_base=2**31 - 32, rounds=32, election_tick=6, heartbeat_tick=1,
             with_cq=with_cq),
        seed=P)


@needs_gxx
def test_host_builds_refuse_peer_counts_they_lack():
    """Each library takes only its own instances: the narrow ones P <= 7,
    the wide ones P = 8..15 (and the steady one up to its cap)."""
    def rc(host, P, wide, **kw):
        if host is damped_host:
            args = damped_tests.random_operands(P, G, 0, False)
        elif host is chaos_host:
            args = chaos_tests.random_inputs(P, G, 0)
        else:
            args = steady_tests._random_inputs(P, G, 0)
        return host(args, None, wide=wide, **kw)[0]

    skw = dict(rounds=1, election_tick=10, heartbeat_tick=1)
    ckw = dict(skw, round_base=0)
    dkw = dict(ckw, with_cq=True)
    assert rc(steady_host, 8, wide=False, **skw) != 0
    assert rc(steady_host, 7, wide=True, **skw) != 0
    assert rc(steady_host, steady_kernel.MAX_PEERS + 1, wide=True, **skw) != 0
    assert rc(chaos_host, 16, wide=True, **ckw) != 0
    assert rc(damped_host, 16, wide=True, **dkw) != 0
    assert rc(damped_host, 8, wide=False, **dkw) != 0


def test_chaos_and_damped_rounds_refuse_p16_like_the_reference():
    """The reference's chaos and damped builders assert P <= 15 (its packed
    roles word); the port's builders raise ValueError there."""
    assert MAX_PEERS == 15
    lossy = tsim.SimConfig(n_groups=4, n_peers=16, election_tick=64)
    damped = tsim.SimConfig(n_groups=4, n_peers=16, election_tick=64, check_quorum=True)
    with pytest.raises(ValueError, match="4 bits for leader_id"):
        fused_step.chaos_round(lossy, 8)
    with pytest.raises(ValueError, match="4 bits for leader_id"):
        fused_step.damped_round(damped, 8)
    with pytest.raises(ValueError, match="4 bits for leader_id"):
        fused_step.fast_multi_round(damped, k=8)
    # P = 15 builds.
    fused_step.chaos_round(tsim.SimConfig(n_groups=4, n_peers=15, election_tick=64), 8)
    fused_step.steady_round(tsim.SimConfig(n_groups=4, n_peers=16), 8)
