"""The fused kernels past P = 7 (csrc/*_round_wide.cu's bodies, built with
g++ from csrc/*_host_wide.cpp) held to their plain versions on random
planes at P = 8, 11 and 15, in every flag variant (steady with_health;
chaos with_health; damped with_cq, with_loss, with_health), and the steady
kernel's warp body (csrc/steady_warp_body.cuh, the card's instance from
steady_kernel.WARP_PEERS = 13 on; the host shim emulates the group's 16
or 32 lanes) at P = 15, 16, 17, 31, 32, 33, 64, 65, 100 and 128 on random
planes, on random planes with one acting leader and with values across
the whole int32 range, and on settled planes at P = 17 and 65, both
variants; below the switch, P = 1..12, too.  Past P = 15 the chaos and damped
rounds refuse the config, as the reference's builders assert P <= 15;
the steady path has no such limit in the reference and none in the port
but the card's shared memory (one group's tile past P = 8,015), which the
host build refuses as the card's launcher does.  The fused steady branch
at P = 65 and 128 on the CPU.  Exact.

The port's fast_multi_round at P = 8, 16, 17 and 33 against raft_tpu's,
with the Pallas kernel in interpret mode, is in
test_torch_wide_peers_slice.py."""

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
# The steady warp body's peer counts: each side of 32, 64 and 96 lanes'
# worth of slots (J = 1..4 in registers), and one past the register
# instances' 128 is the runtime-J one, held at 129 below.
WARP = (16, 17, 31, 32, 33, 64, 65, 100, 128)
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


STEADY_KW = dict(rounds=32, election_tick=10, heartbeat_tick=1)


@needs_gxx
@pytest.mark.parametrize("P", WIDE + WARP)
def test_steady_host_equals_plain(P):
    args = steady_tests._random_inputs(P, G, seed=P)
    assert_host_equals_plain(steady_host, steady_rounds_reference, STEADY_OUTPUTS,
                             args, STEADY_KW, seed=P)


@needs_gxx
def test_steady_host_settled_p8():
    args = steady_tests._settled_inputs(8, G)
    assert_host_equals_plain(steady_host, steady_rounds_reference, STEADY_OUTPUTS,
                             args, STEADY_KW, seed=1)


def one_acting_leader(args, seed):
    """Steady operands with exactly one acting leader a group (the warp
    body's closed-form majority index), the other peers random followers
    and candidates."""
    P, n = args[0].shape
    rng = np.random.default_rng(seed)
    state = torch.from_numpy(rng.integers(0, 2, (P, n)).astype(np.int32))
    crashed = args[10].clone()
    lead, idx = rng.integers(0, P, n), np.arange(n)
    state[lead, idx] = 2
    crashed[lead, idx] = False
    return (state,) + tuple(args[1:10]) + (crashed,) + tuple(args[11:])


def whole_int32_range(args, seed):
    """Steady operands whose timers, indexes, terms, term starts and commits
    span the whole int32 range (sums wrap; the selection's sign bias), and
    whose append counts may be negative."""
    P, n = args[0].shape
    rng = np.random.default_rng(seed)

    def ints(shape, lo=-2**31):
        return torch.from_numpy(rng.integers(lo, 2**31, shape, dtype=np.int64).astype(np.int32))

    out = list(args)
    for i in range(2, 8):  # ee, hb, li, lt, the acting row, commit
        out[i] = ints((P, n))
    out[11], out[12] = ints((n,)), ints((n,), lo=-3)
    return tuple(out)


@needs_gxx
@pytest.mark.parametrize("P", (16, 33, 65, 128))
@pytest.mark.parametrize("planes", ["one leader", "int32 range", "both"])
def test_steady_warp_host_leader_arms_and_wrapping(P, planes):
    """The warp body's closed-form arm (one acting leader) and its selection
    arm (none or several) on values that wrap and cross zero."""
    args = steady_tests._random_inputs(P, G, seed=100 + P)
    if planes != "one leader":
        args = whole_int32_range(args, P)
    if planes != "int32 range":
        args = one_acting_leader(args, P)
    for ticks in ((10, 1), (6, 3)):
        assert_host_equals_plain(
            steady_host, steady_rounds_reference, STEADY_OUTPUTS, args,
            dict(rounds=32, election_tick=ticks[0], heartbeat_tick=ticks[1]), seed=P)


@needs_gxx
@pytest.mark.parametrize("P", (17, 65))
def test_steady_host_settled_wide(P):
    args = steady_tests._settled_inputs(P, G)
    assert_host_equals_plain(steady_host, steady_rounds_reference, STEADY_OUTPUTS,
                             args, STEADY_KW, seed=2)


def steady_warp_host(args, tsc, **kw):
    """The warp body's host shim at any P (steady_warp_host), as
    steady_host calls the library's dispatcher."""
    P = args[0].shape[0]
    outs = [torch.empty((P, G), dtype=torch.int32) for _ in range(6)]
    tsc_out = None if tsc is None else torch.empty(G, dtype=torch.int32)
    rc = _build.load_steady_host(8).steady_warp_host(
        *ptrs(args), *ptrs(outs), *ptrs((tsc, tsc_out)), G, P, kw["rounds"],
        kw["election_tick"], kw["heartbeat_tick"], int(tsc is not None))
    return rc, outs + ([] if tsc is None else [tsc_out])


@needs_gxx
@pytest.mark.parametrize("P", (1, 2, 5, 12, 13, 129))
def test_steady_warp_host_both_sides_of_the_switch(P):
    """The warp body below steady_kernel.WARP_PEERS (where the card runs the
    thread-a-group instances; the timing tool runs it there too), at the
    switch and at P = 129, the first runtime-J width, on random planes and
    with one acting leader."""
    args = steady_tests._random_inputs(P, G, seed=200 + P)
    for planes in (args, one_acting_leader(args, P)):
        assert_host_equals_plain(steady_warp_host, steady_rounds_reference,
                                 STEADY_OUTPUTS, planes, STEADY_KW, seed=P)


@needs_gxx
def test_steady_warp_block_shape_and_refusal():
    """The card's block shape, which the host build exports as the CUDA
    build does (steady_warp_block_groups): 16 half-warp groups a block up
    to P = 16, 8 whole-warp groups while their tile fits, fewer past it;
    and the one width the kernel refuses, a group whose tile passes a
    block's shared memory, raises ValueError in the wrapper before any
    launch."""
    lib = _build.load_steady_host(8)
    shape = {P: lib.steady_warp_block_groups(P) for P in range(1, 9000)}
    widest = max(P for P, groups in shape.items() if groups)
    assert widest == 8015 and shape[widest + 1] == 0
    assert shape[16] == 16 and shape[17] == 8 and shape[128] == 8
    assert all(shape[P] >= shape[P + 1] for P in range(17, 8999))
    steady_kernel.check_peers(lib, widest)
    with pytest.raises(ValueError, match="does not fit"):
        steady_kernel.check_peers(lib, widest + 1)
    with pytest.raises(ValueError, match="does not fit"):
        steady_kernel.launch(lib, *steady_tests._random_inputs(widest + 1, 1, 0), None,
                             **STEADY_KW)


@pytest.mark.parametrize("P", (65, 128))
def test_fused_steady_branch_past_sixty_four_peers(P):
    """fused_step.steady_round and fast_multi_round build at P = 65 and 128
    (the card took P <= 64 before the warp instance) and, from a settled
    state on the CPU, take the fused branch, equal to as many general
    steps on every field."""
    n, k = 4, 4
    cfg = tsim.SimConfig(n_groups=n, n_peers=P)
    s = tsim.ClusterSim(cfg, device="cpu")
    crashed = torch.zeros((P, n), dtype=torch.bool)
    app = torch.ones(n, dtype=torch.int32)
    s.run(20, crashed, app)
    got, fused = fused_step.fast_multi_round(cfg, k=k, count_fused=True)(
        s.state, crashed, app, 0)
    assert fused == k * n
    alone = fused_step.steady_round(cfg, rounds=k)(s.state, crashed, app)
    want = s.state
    for _ in range(k):
        want = tsim.step(cfg, want, crashed, app)
    for f in tsim.SimState._fields:
        a, b, c = getattr(got, f), getattr(alone, f), getattr(want, f)
        assert (a is None) == (c is None), f
        if a is not None:
            assert torch.equal(a, b) and torch.equal(a, c), f


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
    the wide ones P = 8..15 (the steady one P = 8..12, then the warp body,
    every P whose one-group tile fits a block's shared memory on the
    card)."""
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
    assert rc(steady_host, 8016, wide=True, **skw) != 0  # past the shared memory
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


@pytest.mark.parametrize("P", (16, 33, 65, 129))
def test_steady_wide_body_work_counts_peers_not_slots(P):
    """steady_wide_body_work charges the group's P peers, not the lanes'
    padded slots: one peer more adds the same operations at every width,
    J = ceil(P / 32) included; the selections and their radix steps add
    what they take; the bytes are steady_work's."""
    G, k = 100, 32

    def ops(n, **kw):
        return steady_kernel.steady_wide_body_work(n, G, k, **kw)[1]

    step = ops(P) - ops(P - 1)
    assert step == (15 * k + 30) * G
    assert ops(P + 1) - ops(P) == step
    assert ops(P, with_health=True) - ops(P) == (5 * k + 6 * P) * G
    assert ops(P, selections=(3, 40)) - ops(P) == 3 * (9 * P + 10) + 40 * (2 * P + 4)
    assert steady_kernel.steady_wide_body_work(P, G, k)[0] == steady_kernel.steady_work(
        P, G, k)[0]


def test_warp_selections_count_the_one_leader_groups():
    """warp_selections on settled planes: no selection where a sent round's
    written voters alone settle the majority; with three of five peers
    down, two selections in each group of one acting leader (positions
    qpos - m and qpos of the fixed values), each as many radix steps as
    the bit length of the fixed values' spread; none in a group with two
    acting leaders (it selects each sent round instead)."""
    P, n = 5, 3
    state = torch.zeros((P, n), dtype=torch.int32)
    state[0] = 2
    voter = member = torch.ones((P, n), dtype=torch.bool)
    crashed = torch.zeros((P, n), dtype=torch.bool)
    row = torch.full((P, n), 100, dtype=torch.int32)

    def count():
        return steady_kernel.warp_selections(state, voter, member, crashed, row)

    assert count() == (0, 0)
    crashed[1] = True
    assert count() == (0, 0)  # qpos 2 < m 4, and the fixed part has one value
    crashed[1:4] = True
    row[1:4] = 96
    assert count() == (6, 0)  # fixed part {96, 96, 96}: lo == hi, no step
    row[3, 0] = 64
    assert count() == (6, 12)  # 96 ^ 64 = 32, six bits, in both of group 0's
    state[4, 1] = 2
    assert count() == (4, 12)
