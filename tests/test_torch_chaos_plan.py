"""The port's chaos plan compiler and its pieces against the JAX package's,
on the CPU, exactly: the packed-word packers, `compile_plan`'s five
schedule arrays for the golden plans (tests/testdata/chaos/plans.json and
examples/chaos/partition_heal.json) at G=8 and a ragged 13, `schedule_masks`
for every round, `host_loss_draw`, `update_chaos_stats`, and
`check_safety` on the reference's invariant fixtures and on random planes
with the joint-window and lease arguments.

The port keeps the reference's uint32 words as int32 tensors of the same
bits, so words compare through `numpy.view(np.uint32)`.  Kernel functions
are looked up with getattr (see ROADMAP, "Kernel names in port tests")."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import kernels as jk
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import kernels as tk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kfn(mod, name):
    return getattr(mod, name)


def golden_docs():
    with open(os.path.join(ROOT, "tests", "testdata", "chaos", "plans.json"),
              encoding="utf-8") as f:
        docs = json.load(f)
    with open(os.path.join(ROOT, "examples", "chaos", "partition_heal.json"),
              encoding="utf-8") as f:
        docs.append(json.load(f))
    return {d["name"]: d for d in docs}


PLANS = golden_docs()


def words(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("P", [3, 5, 6])
def test_packers_match_jax(P):
    """pack_bits/unpack_bits over P*P planes (two words at P=6, so bit 31
    and a ragged second word), pack_u16_pairs/unpack_u16_pairs with high
    halfwords past 2**15."""
    rng = np.random.RandomState(P)
    K, G = P * P, 11
    planes = rng.rand(K, 2, G) < 0.5
    planes[min(31, K - 1)] = True  # the top bit of the first word, set
    planes[K - 1, :, 0] = True
    jw = np.asarray(kfn(jk, "pack_bits")(jnp.asarray(planes)))
    tw = kfn(tk, "pack_bits")(torch.from_numpy(planes))
    assert tw.shape == jw.shape == ((K + 31) // 32, 2, G)
    np.testing.assert_array_equal(words(tw), jw)
    back = kfn(tk, "unpack_bits")(tw, K)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), planes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(kfn(jk, "unpack_bits")(jnp.asarray(jw), K)))

    vals = rng.randint(0, 2**16, size=(K, 3, G)).astype(np.int32)
    vals[1] = 0xFFFF  # the high halfword all ones: bit 31 set
    jw = np.asarray(kfn(jk, "pack_u16_pairs")(jnp.asarray(vals)))
    tw = kfn(tk, "pack_u16_pairs")(torch.from_numpy(vals))
    assert tw.shape == jw.shape == ((K + 1) // 2, 3, G)
    np.testing.assert_array_equal(words(tw), jw)
    back = kfn(tk, "unpack_u16_pairs")(tw, K)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(kfn(jk, "unpack_u16_pairs")(jnp.asarray(jw), K)))


@pytest.mark.parametrize("G", [8, 13])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_compile_plan_matches_jax(name, G):
    jc = jchaos.compile_plan(jchaos.plan_from_dict(PLANS[name]), G)
    tc = tchaos.compile_plan(tchaos.plan_from_dict(PLANS[name]), G, device="cpu")
    assert tc.n_peers == jc.n_peers and tc.n_rounds == jc.n_rounds
    np.testing.assert_array_equal(tc.phase_of_round.numpy(),
                                  np.asarray(jc.phase_of_round))
    assert tc.phase_of_round.dtype == torch.int32
    for field in ("link_packed", "loss_packed", "crashed_packed"):
        want = np.asarray(getattr(jc, field))
        got = words(getattr(tc, field))
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert tc.append.dtype == torch.int32
    np.testing.assert_array_equal(tc.append.numpy(), np.asarray(jc.append))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_schedule_masks_match_jax_every_round(name):
    G = 13
    jc = jchaos.compile_plan(jchaos.plan_from_dict(PLANS[name]), G)
    tc = tchaos.compile_plan(tchaos.plan_from_dict(PLANS[name]), G, device="cpu")
    jmasks = jax.jit(lambda r: jchaos.schedule_masks(jc, r))
    host = tchaos.HostSchedule(tchaos.plan_from_dict(PLANS[name]), G)
    for r in range(tc.n_rounds):
        want = [np.asarray(a) for a in jmasks(jnp.int32(r))]
        got = tchaos.schedule_masks(tc, r)
        for w, g, h, what in zip(want, got, host.masks(r), ("link", "crashed", "append")):
            assert g.dtype == (torch.int32 if what == "append" else torch.bool)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"round {r} {what}")
            np.testing.assert_array_equal(h, w, err_msg=f"host round {r} {what}")


def test_host_loss_draw_matches_jax():
    rng = np.random.RandomState(7)
    for P, G in ((3, 8), (5, 13)):
        rate = rng.randint(0, jk.LOSS_SCALE + 1, size=(P, P, G)).astype(np.int32)
        for r in (0, 1, 77, 2**31 - 1):
            want = jchaos.host_loss_draw(r, rate)
            np.testing.assert_array_equal(tchaos.host_loss_draw(r, rate), want)
            got = kfn(tk, "link_loss_draw")(r, torch.from_numpy(rate))
            np.testing.assert_array_equal(got.numpy(), want)


def test_update_chaos_stats_matches_jax():
    rng = np.random.RandomState(3)
    G = 13
    js = jnp.zeros((jchaos.N_CHAOS_STATS,), jnp.int32)
    ts = torch.zeros((tchaos.N_CHAOS_STATS,), dtype=torch.int32)
    prev = np.zeros(G, np.int32)
    for _ in range(40):
        new = np.where(rng.rand(G) < 0.5, prev + 1, 0).astype(np.int32)
        js = jchaos.update_chaos_stats(js, jnp.asarray(prev), jnp.asarray(new))
        ts = tchaos.update_chaos_stats(ts, torch.from_numpy(prev), torch.from_numpy(new))
        assert ts.dtype == torch.int32
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        prev = new
    assert tchaos.CHAOS_STAT_NAMES == jchaos.CHAOS_STAT_NAMES
    assert (tchaos.CS_REELECTIONS, tchaos.CS_HEALED_ROUNDS, tchaos.CS_MAX_STREAK,
            tchaos.CS_LEADERLESS_ROUNDS) == (
        jchaos.CS_REELECTIONS, jchaos.CS_HEALED_ROUNDS, jchaos.CS_MAX_STREAK,
        jchaos.CS_LEADERLESS_ROUNDS)


def both_safety(**kw):
    """check_safety of both packages on the same numpy planes: (JAX's,
    the port's) as numpy int32 vectors."""
    want = np.asarray(kfn(jk, "check_safety")(
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()}))
    got = kfn(tk, "check_safety")(
        **{k: None if v is None else torch.from_numpy(np.array(v)) for k, v in kw.items()})
    assert got.dtype == torch.int32 and got.shape == (tk.N_SAFETY,)
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def test_check_safety_flags_each_invariant():
    """The reference's fixtures (test_chaos_parity.py): a clean state, then
    one violation of each base invariant in all four groups."""
    g = 4

    def planes(v):
        return np.full((2, g), v, np.int32)

    lead_follow = np.asarray([[2] * g, [0] * g], np.int32)
    base = dict(term=planes(3), last_index=planes(7), prev_commit=planes(5))
    cases = (
        (None, dict(state=lead_follow, commit=planes(5), agree=6)),
        (tk.SV_DUAL_LEADER, dict(state=np.full((2, g), 2, np.int32),
                                 commit=planes(5), agree=6)),
        (tk.SV_COMMIT_DIVERGED, dict(state=planes(0), commit=planes(5), agree=4)),
        (tk.SV_COMMIT_REGRESSED, dict(state=planes(0), commit=planes(4), agree=6)),
        (tk.SV_CURSOR_INVALID, dict(state=planes(0), commit=planes(9), agree=6)),
    )
    for slot, kw in cases:
        kw = dict(base, **dict(kw, agree=np.full((2, 2, g), kw["agree"], np.int32)))
        got = both_safety(**kw)
        if slot is None:
            assert not got.any()
        else:
            assert got[slot] == g
    assert tk.SAFETY_NAMES == jk.SAFETY_NAMES and tk.N_SAFETY == jk.N_SAFETY


def random_safety_planes(rng, P, G):
    def ints(hi, shape=(P, G)):
        return rng.randint(0, hi, size=shape).astype(np.int32)

    def bools(p, shape=(P, G)):
        return rng.rand(*shape) < p

    return dict(
        state=ints(3), term=ints(3), commit=ints(8), last_index=ints(9),
        agree=ints(9, (P, P, G)), prev_commit=ints(8),
        voter_mask=bools(0.7), outgoing_mask=bools(0.3),
        matched=ints(9, (P, P, G)), crashed=bools(0.2),
        prev_voter_mask=bools(0.7), prev_outgoing_mask=bools(0.3),
        lease_holder=bools(0.3), lease_fire=bools(0.5, (G,)),
    )


JOINT = ("voter_mask", "outgoing_mask", "matched")
ARG_SETS = {
    "base": (),
    "joint": JOINT,
    "joint+crashed": JOINT + ("crashed",),
    "joint+double-change": JOINT + ("crashed", "prev_voter_mask", "prev_outgoing_mask"),
    "lease": ("lease_holder",),
    "lease+fire": ("lease_holder", "lease_fire"),
    "all": JOINT + ("crashed", "prev_voter_mask", "prev_outgoing_mask",
                    "lease_holder", "lease_fire"),
}


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("args", sorted(ARG_SETS))
def test_check_safety_random_planes_match_jax(args, P):
    """Random planes (several leaders a term, regressions, joint configs,
    double changes, stacked leases) with each set of optional arguments;
    some slot must fire, so the comparison sees nonzero counts."""
    rng = np.random.RandomState(P * 100 + len(args))
    planes = random_safety_planes(rng, P, 64)
    base = ("state", "term", "commit", "last_index", "agree", "prev_commit")
    kw = {k: planes[k] for k in base + ARG_SETS[args]}
    got = both_safety(**kw)
    assert got.any()
    if ARG_SETS[args]:
        assert got[4:].any() or args == "joint+crashed"


def test_check_safety_arg_validation():
    rng = np.random.RandomState(1)
    planes = random_safety_planes(rng, 3, 4)
    base = {k: planes[k] for k in ("state", "term", "commit", "last_index",
                                    "agree", "prev_commit")}
    for extra, match in (
        (("voter_mask",), "voter_mask"),
        (("voter_mask", "outgoing_mask"), "voter_mask"),
        (("prev_voter_mask",), "double-change"),
        (("lease_fire",), "lease_holder"),
    ):
        kw = dict(base, **{k: planes[k] for k in extra})
        for mod, conv in ((jk, jnp.asarray), (tk, torch.from_numpy)):
            with pytest.raises(ValueError, match=match):
                kfn(mod, "check_safety")(**{k: conv(np.array(v)) for k, v in kw.items()})


@pytest.mark.parametrize("bad", [
    {"peers": 3, "phases": []},
    {"peers": 3, "phases": [{"rounds": 0}]},
    {"peers": 3, "phases": [{"rounds": 4, "crash": [4]}]},
    {"peers": 3, "phases": [{"rounds": 4, "partition": [[0, 1]]}]},
    {"peers": 3, "phases": [{"rounds": 4, "loss_all": 1.5}]},
    {"peers": 3, "phases": [{"rounds": 4, "groups": "some"}]},
    {"peers": 3, "phases": [{"rounds": 4, "groups": [8]}]},
    {"peers": 3, "phases": [{"rounds": 2**28}]},
])
def test_plan_validation_matches_jax(bad):
    """A malformed plan raises ValueError in both packages, the int32
    (group, round) guard included (2**28 rounds x 8 groups)."""
    for mod, kw in ((jchaos, {}), (tchaos, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.compile_plan(mod.plan_from_dict(bad), 8, **kw)


def test_loaded_plan_matches_jax():
    path = os.path.join(ROOT, "examples", "chaos", "partition_heal.json")
    jp, tp = jchaos.load_plan(path), tchaos.load_plan(path)
    assert (tp.name, tp.n_peers, tp.n_rounds) == (jp.name, jp.n_peers, jp.n_rounds)
    assert [vars(a) for a in tp.phases] == [vars(b) for b in jp.phases]
