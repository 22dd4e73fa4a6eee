"""The port's client-read protocol against the JAX package on the CPU,
exactly (every plane is int32 or bool):

  * `kernels.pack_bits_g` and `unpack_bits_g` against the reference's uint32
    words at ragged and whole-word widths;
  * `kernels.acting_leader_id` and `kernels.lease_read` (the holder mask,
    served and index) on random planes, settled check-quorum states, crashed
    leaders, a paused clock, the transferee arm and the undamped static arm;
  * `sim.read_index` with and without a link plane, and
    `sim._read_quorum_damped`, on random and settled states;
  * `sim.step(read_propose=)` on the plain, the link-gated and the damped
    round over tests/test_read_lease.py's storm schedules: the receipt and
    the state every round;
  * the lease_read-without-check_quorum refusal, and the stale-read trap of
    tests/test_read_lease.py run in both packages: with the clock paused it
    fires SV_STALE_READ and SV_DUAL_LEASE, without the pause neither.

Kernel functions are looked up by name (getattr), so the JAX package's
parity-obligation baseline stays as it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import autopilot as tap
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim
from raft_tpu_torch.multiraft import workload as twl

from test_torch_reconfig import kfn
from test_torch_sim import assert_states_equal

_STEPS = {}


def jstep_for(cfg):
    """One jitted JAX step per config for the whole module (its damped
    compile is most of this file's time)."""
    fn = _STEPS.get(cfg)
    if fn is None:
        fn = _STEPS[cfg] = jax.jit(
            lambda s, c, a, l, rp: jsim.step(cfg, s, c, a, link=l, read_propose=rp))
    return fn


def pair_cfg(**kw):
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


def to_jax(arrays):
    """A JAX SimState from numpy planes keyed by field name."""
    return jsim.SimState(**{
        f: None if arrays.get(f) is None else jnp.asarray(arrays[f])
        for f in jsim.SimState._fields})


def random_planes(seed, P, G, damped=True):
    """Random state planes: any roles, terms, commits, masks and (damped)
    recent_active rows, several or no leaders a group; crashed peers."""
    rng = np.random.default_rng(seed)

    def ints(hi, shape=(P, G)):
        return rng.integers(0, hi, shape).astype(np.int32)

    arrays = dict(
        term=ints(4), state=ints(4), vote=ints(P + 1), leader_id=ints(P + 1),
        election_elapsed=ints(14), heartbeat_elapsed=ints(3),
        randomized_timeout=ints(20), last_index=ints(30), last_term=ints(4),
        commit=ints(20), matched=ints(30, (P, P, G)), term_start_index=ints(12),
        agree=ints(30, (P, P, G)), voter_mask=rng.random((P, G)) < 0.8,
        outgoing_mask=rng.random((P, G)) < 0.25, learner_mask=rng.random((P, G)) < 0.2,
        recent_active=(rng.random((P, P, G)) < 0.7) if damped else None,
    )
    # Leaders that name themselves now and then, so the lease gate can pass.
    self_id = np.arange(1, P + 1, dtype=np.int32)[:, None]
    arrays["leader_id"] = np.where(rng.random((P, G)) < 0.5, self_id, arrays["leader_id"])
    crashed = rng.random((P, G)) < 0.2
    link = rng.random((P, P, G)) < 0.8
    return arrays, crashed, link


_SETTLED = {}


def settled(P, G, check_quorum, rounds=30, election_tick=10):
    """(JAX state, port state) after `rounds` lockstep rounds of one append a
    group, memoized per configuration."""
    key = (P, G, check_quorum, rounds, election_tick)
    if key not in _SETTLED:
        jcfg, tcfg = pair_cfg(n_groups=G, n_peers=P, election_tick=election_tick,
                              check_quorum=check_quorum, lease_read=check_quorum)
        jst, tst = jsim.init_state(jcfg), tsim.init_state(tcfg, device="cpu")
        step = jstep_for(jcfg)
        link = jnp.ones((P, P, G), bool) if check_quorum else None
        zeros = jnp.zeros((G,), jnp.int32)
        for _ in range(rounds):
            jst, _ = step(jst, jnp.zeros((P, G), bool), jnp.ones((G,), jnp.int32),
                          link, zeros)
            tst = tsim.step(tcfg, tst, torch.zeros((P, G), dtype=torch.bool),
                            torch.ones(G, dtype=torch.int32))
        assert_states_equal(jst, tst, "settle")
        _SETTLED[key] = (jst, tst)
    return _SETTLED[key]


# --- the packed group words ------------------------------------------------


@pytest.mark.parametrize("G", [1, 31, 32, 33, 100])
def test_pack_bits_g_matches_jax(G):
    rng = np.random.default_rng(G)
    for shape in ((G,), (3, G), (2, 4, G)):
        plane = rng.random(shape) < 0.5
        want = np.asarray(kfn(jk, "pack_bits_g")(jnp.asarray(plane)))
        got = kfn(tk, "pack_bits_g")(torch.from_numpy(plane))
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        back = kfn(tk, "unpack_bits_g")(got, G)
        assert back.dtype == torch.bool
        np.testing.assert_array_equal(back.numpy(), plane)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(kfn(jk, "unpack_bits_g")(jnp.asarray(want), G)))
    # Every bit set: the sign bit of each word's int32 pattern.
    full = np.ones((G,), bool)
    got = kfn(tk, "pack_bits_g")(torch.from_numpy(full)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(kfn(jk, "pack_bits_g")(jnp.asarray(full))))


# --- the acting leader and the lease gate ------------------------------------


def lease_args(arrays, crashed, election_tick, check_quorum, transferee=None):
    names = ("state", "term", "leader_id", "election_elapsed", "commit",
             "term_start_index")
    jargs = tuple(jnp.asarray(arrays[n]) for n in names) + (
        jnp.asarray(crashed), election_tick, check_quorum,
        None if transferee is None else jnp.asarray(transferee),
        None if arrays["recent_active"] is None else jnp.asarray(arrays["recent_active"]),
        jnp.asarray(arrays["voter_mask"]), jnp.asarray(arrays["outgoing_mask"]))
    targs = tuple(torch.from_numpy(np.asarray(arrays[n])) for n in names) + (
        torch.from_numpy(np.asarray(crashed)), election_tick, check_quorum,
        None if transferee is None else torch.from_numpy(transferee),
        None if arrays["recent_active"] is None
        else torch.from_numpy(np.asarray(arrays["recent_active"])),
        torch.from_numpy(np.asarray(arrays["voter_mask"])),
        torch.from_numpy(np.asarray(arrays["outgoing_mask"])))
    return jargs, targs


def assert_lease_equal(jargs, targs, note):
    want = kfn(jk, "lease_read")(*jargs)
    got = kfn(tk, "lease_read")(*targs)
    for name, w, g, dt in zip(("holder", "served", "index"), want, got,
                              (torch.bool, torch.bool, torch.int32)):
        assert g.dtype == dt, (note, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{note}: {name}")
    return got


@pytest.mark.parametrize("seed", range(4))
def test_acting_leader_and_lease_read_on_random_planes(seed):
    P, G = (3, 5, 5, 7)[seed], 16
    arrays, crashed, _ = random_planes(seed, P, G)
    for cr in (crashed, np.zeros_like(crashed)):
        want = np.asarray(kfn(jk, "acting_leader_id")(
            jnp.asarray(arrays["state"]), jnp.asarray(arrays["term"]), jnp.asarray(cr)))
        got = kfn(tk, "acting_leader_id")(
            torch.from_numpy(arrays["state"]), torch.from_numpy(arrays["term"]),
            torch.from_numpy(cr))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want > 0).any() and (want == 0).any()
        transferee = np.where(np.random.default_rng(seed).random((P, G)) < 0.3,
                              1, 0).astype(np.int32)
        for cq in (False, True):
            for tr in (None, transferee):
                got = assert_lease_equal(*lease_args(arrays, cr, 10, cq, tr),
                                         f"seed {seed} cq={cq} tr={tr is not None}")
                if cq and tr is None:
                    assert got[1].any(), "the gate never passed"
                if not cq:
                    assert not got[0].any()


def test_lease_read_on_settled_crashed_and_paused_states():
    """A settled check-quorum fleet serves every group; crashed leaders and
    a clock past the lease window close the gate; the undamped config's
    static arm serves none."""
    P, G = 3, 8
    jst, tst = settled(P, G, True)
    arrays = tsim.state_to_numpy(tst)
    no_crash = np.zeros((P, G), bool)
    got = assert_lease_equal(*lease_args(arrays, no_crash, 10, True), "settled")
    assert got[1].all() and (got[0].sum(0) == 1).all()
    lead = arrays["state"].argmax(0)
    crashed = no_crash.copy()
    crashed[lead[::2], np.arange(G)[::2]] = True
    got = assert_lease_equal(*lease_args(arrays, crashed, 10, True), "crashed leaders")
    assert not got[1][::2].any() and got[1][1::2].all()
    paused = dict(arrays, election_elapsed=np.where(
        arrays["state"] == tk.ROLE_LEADER, 10, arrays["election_elapsed"]).astype(np.int32))
    got = assert_lease_equal(*lease_args(paused, no_crash, 10, True), "past the window")
    assert not got[1].any()
    got = assert_lease_equal(*lease_args(arrays, no_crash, 10, False), "static arm")
    assert not got[1].any() and not got[2].any()


def test_lease_read_needs_the_damping_planes():
    arrays, crashed, _ = random_planes(9, 3, 8, damped=False)
    jargs, targs = lease_args(arrays, crashed, 10, True)
    with pytest.raises(ValueError) as want:
        kfn(jk, "lease_read")(*jargs)
    with pytest.raises(ValueError) as got:
        kfn(tk, "lease_read")(*targs)
    assert "recent_active" in str(got.value) and "recent_active" in str(want.value)


# --- the ReadIndex barriers ----------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_read_index_and_damped_barrier_on_random_planes(seed):
    P, G = (3, 5, 7)[seed], 16
    arrays, crashed, link = random_planes(10 + seed, P, G)
    jcfg, tcfg = pair_cfg(n_groups=G, n_peers=P, check_quorum=True)
    jst, tst = to_jax(arrays), tsim.state_from_numpy(arrays, "cpu")
    served = 0
    for cr in (crashed, np.zeros_like(crashed)):
        for ln in (None, link):
            jl = None if ln is None else jnp.asarray(ln)
            tl = None if ln is None else torch.from_numpy(ln)
            for fn in ("read_index", "_read_quorum_damped"):
                want = np.asarray(getattr(jsim, fn)(jcfg, jst, jnp.asarray(cr), jl))
                got = getattr(tsim, fn)(tcfg, tst, torch.from_numpy(cr), tl)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{fn} link={ln is not None}")
                served += int((want >= 0).sum())
    assert served > 0


@pytest.mark.parametrize("check_quorum", [False, True], ids=["undamped", "check_quorum"])
def test_barriers_and_probes_on_settled_states(check_quorum):
    """read_index and the damped barrier on a settled fleet, with one
    follower down in half the groups and a one-way cut; ClusterSim's
    read_index and lease_read probes on the same state."""
    P, G = 3, 8
    jst, tst = settled(P, G, check_quorum)
    jcfg, tcfg = pair_cfg(n_groups=G, n_peers=P, check_quorum=check_quorum,
                          lease_read=check_quorum)
    crashed = np.zeros((P, G), bool)
    lead = np.asarray(jst.state).argmax(0)
    crashed[(lead[::2] + 1) % P, np.arange(G)[::2]] = True
    link = np.ones((P, P, G), bool)
    link[lead[1::2], (lead[1::2] + 2) % P, np.arange(G)[1::2]] = False
    for cr in (np.zeros_like(crashed), crashed):
        for ln in (None, link):
            jl = None if ln is None else jnp.asarray(ln)
            tl = None if ln is None else torch.from_numpy(ln)
            for fn in ("read_index", "_read_quorum_damped"):
                want = np.asarray(getattr(jsim, fn)(jcfg, jst, jnp.asarray(cr), jl))
                got = getattr(tsim, fn)(tcfg, tst, torch.from_numpy(cr), tl)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)
                assert (want >= 0).all()
    sim = tsim.ClusterSim(tcfg, device="cpu")
    sim.state = tst
    np.testing.assert_array_equal(
        sim.read_index().numpy(),
        np.asarray(jsim.read_index(jcfg, jst, jnp.zeros((P, G), bool))))
    probe = getattr(sim, "lease_read")()
    assert probe.dtype == torch.int32
    _, served, index = kfn(jk, "lease_read")(
        jst.state, jst.term, jst.leader_id, jst.election_elapsed, jst.commit,
        jst.term_start_index, jnp.zeros((P, G), bool), 10, check_quorum,
        jst.transferee, jst.recent_active, jst.voter_mask, jst.outgoing_mask)
    np.testing.assert_array_equal(probe.numpy(),
                                  np.where(np.asarray(served), np.asarray(index), -1))
    assert (probe >= 0).all() == check_quorum


# --- step(read_propose=) --------------------------------------------------------


def assert_receipts_equal(jr, tr, note):
    assert isinstance(tr, tsim.ReadReceipt)
    for f, dt in zip(tsim.ReadReceipt._fields, (torch.int32, torch.bool, torch.bool)):
        g, w = getattr(tr, f), np.asarray(getattr(jr, f))
        assert g.dtype == dt, (note, f)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{note}: receipt {f}")


@pytest.mark.parametrize("kind,seed", [("plain", 11), ("linked", 5), ("damped", 23)])
def test_step_read_propose_matches_jax(kind, seed):
    """tests/test_read_lease.py's storm schedule (run_read_storm: crash
    toggles, leader crashes, heals, 0-2 appends and a random read mode a
    group every round), 40 rounds at G=2 x P=3; the link-gated case adds a
    random 90%-up link plane.  The receipt and the whole state every
    round."""
    G, P, rounds = 2, 3, 40
    damped = kind == "damped"
    jcfg, tcfg = pair_cfg(n_groups=G, n_peers=P, check_quorum=damped, lease_read=damped)
    jst, tst = jsim.init_state(jcfg), tsim.init_state(tcfg, device="cpu")
    step = jstep_for(jcfg)
    rng = np.random.RandomState(seed)
    link_rng = np.random.default_rng(seed)
    crashed = np.zeros((G, P), bool)
    kinds = set()
    for r in range(rounds):
        state_h = np.asarray(jst.state).T
        for g in range(G):
            roll = rng.rand()
            if roll < 0.10:
                crashed[g, rng.randint(P)] ^= True
            elif roll < 0.14:
                leaders = np.where(state_h[g] == 2)[0]
                if len(leaders):
                    crashed[g, leaders[0]] = True
            elif roll < 0.16:
                crashed[g, :] = False
            if crashed[g].sum() == P:
                crashed[g, rng.randint(P)] = False
        append = rng.randint(0, 3, size=G).astype(np.int32)
        modes = rng.randint(0, 3, size=G).astype(np.int32)
        link = None
        if kind == "linked":
            link = link_rng.random((P, P, G)) < 0.9
        elif damped:
            link = np.ones((P, P, G), bool)
        jst, jr = step(jst, jnp.asarray(crashed.T), jnp.asarray(append),
                       None if link is None else jnp.asarray(link), jnp.asarray(modes))
        tst, tr = tsim.step(tcfg, tst, torch.from_numpy(crashed.T.copy()),
                            torch.from_numpy(append),
                            link=None if link is None else torch.from_numpy(link),
                            read_propose=torch.from_numpy(modes))
        assert_receipts_equal(jr, tr, f"{kind} round {r}")
        assert_states_equal(jst, tst, f"{kind} round {r}")
        idx, lease = tr.index.numpy(), tr.lease.numpy()
        kinds |= {("served" if i >= 0 else "failed", bool(le)) for i, le in zip(idx, lease)}
    assert ("served", False) in kinds and ("failed", False) in kinds
    if damped:
        assert ("served", True) in kinds


def test_step_read_receipt_comes_last_and_extras_unchanged():
    """The receipt follows the health extra and the reconfig proposal; the
    round with reads equals the round without them."""
    P, G = 3, 8
    _, tst = settled(P, G, True)
    cfg = tsim.SimConfig(n_groups=G, n_peers=P, check_quorum=True, lease_read=True,
                         collect_health=True)
    crashed = torch.zeros((P, G), dtype=torch.bool)
    append = torch.ones(G, dtype=torch.int32)
    health = tsim.init_health(cfg, "cpu")
    plain = tsim.step(cfg, tst, crashed, append, health=health,
                      reconfig_propose=torch.ones(G, dtype=torch.bool))
    modes = torch.full((G,), tsim.READ_LEASE, dtype=torch.int32)
    out = tsim.step(cfg, tst, crashed, append, health=health,
                    reconfig_propose=torch.ones(G, dtype=torch.bool), read_propose=modes)
    assert len(out) == 4 and isinstance(out[3], tsim.ReadReceipt)
    assert isinstance(out[2], tsim.ReconfigProposal)
    for a, b in zip(plain[0], out[0]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(plain[1].planes, out[1].planes)
    assert out[3].lease.all() and (out[3].index >= 0).all()


def test_lease_read_requires_check_quorum():
    """SimConfig(lease_read=True) without check_quorum is the reference's
    refused configuration: both steps raise the same ValueError."""
    jcfg, tcfg = pair_cfg(n_groups=2, n_peers=3, lease_read=True)
    with pytest.raises(ValueError) as want:
        jsim.step(jcfg, jsim.init_state(jcfg), jnp.zeros((3, 2), bool),
                  jnp.zeros((2,), jnp.int32))
    with pytest.raises(ValueError) as got:
        tsim.step(tcfg, tsim.init_state(tcfg, device="cpu"),
                  torch.zeros((3, 2), dtype=torch.bool), torch.zeros(2, dtype=torch.int32))
    assert str(got.value) == str(want.value)


# --- the stale-read trap ----------------------------------------------------------


def trap_jax(freeze_clock):
    """tests/test_read_lease.py's _inject_trap in the JAX package: (safety,
    receipts by round)."""
    G, P = 2, 3
    cfg = jsim.SimConfig(n_groups=G, n_peers=P, election_tick=10, check_quorum=True,
                         lease_read=True)
    st = jsim.init_state(cfg)
    step = jstep_for(cfg)
    app = jnp.ones((G,), jnp.int32)
    none = jnp.zeros((P, G), bool)
    for _ in range(30):
        st, _ = step(st, none, app, jnp.ones((P, P, G), bool), jnp.zeros((G,), jnp.int32))
    leads = np.asarray(st.state).argmax(axis=0)
    link = np.ones((P, P, G), bool)
    for g in range(G):
        for p in range(P):
            if p != leads[g]:
                link[leads[g], p, g] = link[p, leads[g], g] = False
    lead_mask = jnp.asarray(np.arange(P)[:, None] == leads[None, :])
    safety = jnp.zeros((jk.N_SAFETY,), jnp.int32)
    receipts = []
    for r in range(3 * cfg.election_tick):
        if freeze_clock:
            st = st._replace(election_elapsed=jnp.where(
                lead_mask & (st.state == jk.ROLE_LEADER), 0, st.election_elapsed))
        fire = r == 3 * cfg.election_tick - 1
        modes = jnp.full((G,), jsim.READ_LEASE if fire else 0, jnp.int32)
        holder, _, _ = kfn(jk, "lease_read")(
            st.state, st.term, st.leader_id, st.election_elapsed, st.commit,
            st.term_start_index, none, cfg.election_tick, True, st.transferee,
            st.recent_active, st.voter_mask, st.outgoing_mask)
        prev_commit = st.commit
        st2, receipt = step(st, none, app, jnp.asarray(link), modes)
        safety = safety + kfn(jk, "check_safety")(
            st2.state, st2.term, st2.commit, st2.last_index, st2.agree, prev_commit,
            lease_holder=holder, lease_fire=modes > 0)
        receipts.append(receipt)
        st = st2
    return np.asarray(safety), receipts, st


def trap_port(freeze_clock):
    """The same trap through the port on the CPU."""
    G, P = 2, 3
    cfg = tsim.SimConfig(n_groups=G, n_peers=P, election_tick=10, check_quorum=True,
                         lease_read=True)
    st = tsim.init_state(cfg, device="cpu")
    app = torch.ones(G, dtype=torch.int32)
    none = torch.zeros((P, G), dtype=torch.bool)
    for _ in range(30):
        st = tsim.step(cfg, st, none, app)
    leads = st.state.argmax(0)
    link = torch.ones((P, P, G), dtype=torch.bool)
    for g in range(G):
        for p in range(P):
            if p != int(leads[g]):
                link[leads[g], p, g] = link[p, leads[g], g] = False
    lead_mask = torch.arange(P)[:, None] == leads[None, :]
    safety = torch.zeros(tk.N_SAFETY, dtype=torch.int32)
    receipts = []
    for r in range(3 * cfg.election_tick):
        if freeze_clock:
            st = st._replace(election_elapsed=torch.where(
                lead_mask & (st.state == tk.ROLE_LEADER), 0, st.election_elapsed))
        fire = r == 3 * cfg.election_tick - 1
        modes = torch.full((G,), tsim.READ_LEASE if fire else 0, dtype=torch.int32)
        holder, _, _ = kfn(tk, "lease_read")(
            st.state, st.term, st.leader_id, st.election_elapsed, st.commit,
            st.term_start_index, none, cfg.election_tick, True, st.transferee,
            st.recent_active, st.voter_mask, st.outgoing_mask)
        prev_commit = st.commit
        st2, receipt = tsim.step(cfg, st, none, app, link=link, read_propose=modes)
        safety = safety + kfn(tk, "check_safety")(
            st2.state, st2.term, st2.commit, st2.last_index, st2.agree, prev_commit,
            lease_holder=holder, lease_fire=modes > 0)
        receipts.append(receipt)
        st = st2
    return safety, receipts, st


@pytest.mark.parametrize("freeze_clock", [True, False], ids=["paused_clock", "no_drift"])
def test_stale_read_trap_matches_jax(freeze_clock):
    want, jreceipts, jst = trap_jax(freeze_clock)
    got, treceipts, tst = trap_port(freeze_clock)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for r, (jr, tr) in enumerate(zip(jreceipts, treceipts)):
        assert_receipts_equal(jr, tr, f"trap round {r}")
    assert_states_equal(jst, tst, "trap end")
    fired = got[[tk.SV_STALE_READ, tk.SV_DUAL_LEASE]]
    if freeze_clock:
        assert (fired > 0).all(), got
        assert got[tk.SV_DUAL_LEADER] == 0
    else:
        assert not fired.any(), got


# --- entry points ------------------------------------------------------------------


def test_read_entry_points_default_to_cuda():
    """The read entry points allocate on `cuda` unless told otherwise, and
    raise rather than fall back where there is no card."""
    cfg = tsim.SimConfig(4, 3, collect_health=True, check_quorum=True, lease_read=True)
    plan = twl.ClientPlan("p", 3, [twl.ClientPhase(rounds=8, read_every=2,
                                                   read_mode="lease")])
    calls = (lambda: twl.compile_plan(plan, 4), lambda: twl.init_read_carry(4),
             lambda: tap.empty_reconfig_schedule(8, 3, 4),
             lambda: tsim.ClusterSim(cfg).run_reads(plan),
             lambda: tsim.ClusterSim(cfg).read_index(),
             lambda: getattr(tsim.ClusterSim(cfg), "lease_read")())
    if torch.cuda.is_available():
        assert twl.compile_plan(plan, 4).read_fire_packed.is_cuda
        assert twl.init_read_carry(4).pending_mode.is_cuda
        assert tap.empty_reconfig_schedule(8, 3, 4).op_start.is_cuda
        sim = tsim.ClusterSim(cfg)
        sim.run_reads(plan)
        assert sim._read_carry.pending_mode.is_cuda
        assert sim.read_index().is_cuda and getattr(sim, "lease_read")().is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
    on_cpu = tsim.ClusterSim(cfg, device="cpu")
    assert on_cpu.read_index().device.type == "cpu"
    assert tap.empty_reconfig_schedule(8, 3, 4, "cpu").op_start.device.type == "cpu"
