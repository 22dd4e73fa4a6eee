"""The port's leader transfer against the JAX package on the CPU, exactly
(every plane is int32 or bool):

  * `kernels.apply_transfer` on random planes and on the validation cases
    of tests/test_transfer_batched.py (member, learner and self checks, the
    same-target no-op, the override, the abort-on-self quirk);
  * the transferee arm of `kernels.apply_confchange` on random planes and
    on the removed-target case;
  * `sim.step(transfer_propose=, campaign_kick=)` round by round over the
    schedules of tests/test_transfer_batched.py (basic, lagging target,
    crashed target that pends and aborts, a second transfer overriding the
    first, learner refused, transferee winning mid-partition, the one-way
    ack cut, the kick healing leaderless groups, damped with a kick) on the
    plain, the link-gated and the damped round, at P=3 and one case at
    P=5: every state plane with `transferee`, the counters, the health
    planes, the ReconfigProposal (owner 0 while a transfer blocks) and the
    ReadReceipt;
  * a pending transfer degrading the lease read (tests/test_read_lease.py's
    test_transfer_pending_degrades_lease) through both packages;
  * `fused_step.steady_mask`'s transferee arm, and the fused wrappers and
    `hybrid_multi_round` carrying the plane through a transfer-on state.

Kernel functions are looked up by name (getattr), so the JAX package's
parity-obligation baseline stays as it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.multiraft import kernels as jk
from raft_tpu.multiraft import pallas_step as jps
from raft_tpu.multiraft import sim as jsim
from raft_tpu_torch.multiraft import fused_step as tfs
from raft_tpu_torch.multiraft import kernels as tk
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_reconfig import kfn
from test_torch_sim import assert_states_equal

G, P = 8, 3
WARM_ROUNDS = 14  # every schedule is null before this round

_STEPS = {}
_WARM = {}


def jstep_for(cfg, linked):
    """One jitted JAX step per (config, link or not) for the module, with
    every extra given: counters, health, the proposal and read extras, the
    transfer commands and the kicks."""
    key = (cfg, linked)
    fn = _STEPS.get(key)
    if fn is None:
        fn = _STEPS[key] = jax.jit(
            lambda s, c, a, ctr, h, l, tp, k, rp, rd: jsim.step(
                cfg, s, c, a, counters=ctr, health=h, link=l, reconfig_propose=rp,
                transfer_propose=tp, campaign_kick=k, read_propose=rd))
    return fn


def pair_cfg(p, g, damped):
    kw = dict(n_groups=g, n_peers=p, collect_health=True, collect_counters=True,
              transfer=True, check_quorum=damped, pre_vote=damped,
              lease_read=damped)
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


class Pair:
    """The JAX and the port state, counters and health of one fleet, stepped
    together and compared after every round."""

    def __init__(self, p, g, damped, linked, voters=None, learners=None):
        self.p, self.g, self.linked = p, g, linked or damped
        self.jcfg, self.tcfg = pair_cfg(p, g, damped)
        vm = lm = None
        if voters is not None:
            vm = np.zeros((p, g), bool)
            lm = np.zeros((p, g), bool)
            vm[[v - 1 for v in voters]] = True
            lm[[v - 1 for v in learners]] = True
        self.jst = jsim.init_state(self.jcfg, *(None if m is None else jnp.asarray(m)
                                                for m in (vm, None, lm)))
        self.tst = tsim.init_state(self.tcfg, *(None if m is None else torch.from_numpy(m)
                                                for m in (vm, None, lm)), device="cpu")
        self.jctr, self.tctr = jnp.zeros((4,), jnp.int32), torch.zeros(4, dtype=torch.int32)
        self.jh, self.th = jsim.init_health(self.jcfg), tsim.init_health(self.tcfg, "cpu")
        self.step = jstep_for(self.jcfg, self.linked)

    def copy(self):
        other = object.__new__(Pair)
        other.__dict__.update(self.__dict__)
        return other

    def round(self, r, crashed, append, link=None, tp=None, kick=None, read=None):
        """One round of both packages; crashed [P, G], kick [P, G]."""
        p, g = self.p, self.g
        if link is None and self.linked:
            link = np.ones((p, p, g), bool)
        tp = np.zeros(g, np.int32) if tp is None else np.asarray(tp, np.int32)
        kick = np.zeros((p, g), bool) if kick is None else kick
        read = np.zeros(g, np.int32) if read is None else read
        prop = np.ones(g, bool)
        jout = self.step(
            self.jst, jnp.asarray(crashed), jnp.asarray(append), self.jctr, self.jh,
            None if link is None else jnp.asarray(link), jnp.asarray(tp),
            jnp.asarray(kick), jnp.asarray(prop), jnp.asarray(read))
        tout = tsim.step(
            self.tcfg, self.tst, torch.from_numpy(crashed), torch.from_numpy(append),
            counters=self.tctr, health=self.th,
            link=None if link is None else torch.from_numpy(link),
            reconfig_propose=torch.from_numpy(prop), transfer_propose=torch.from_numpy(tp),
            campaign_kick=torch.from_numpy(kick), read_propose=torch.from_numpy(read))
        self.jst, self.jctr, self.jh, jprop, jrec = jout
        self.tst, self.tctr, self.th, tprop, trec = tout
        note = f"round {r}"
        assert_states_equal(self.jst, self.tst, note)
        np.testing.assert_array_equal(self.tctr.numpy(), np.asarray(self.jctr), err_msg=note)
        np.testing.assert_array_equal(self.th.planes.numpy(), np.asarray(self.jh.planes),
                                      err_msg=f"{note}: health")
        assert self.th.window_pos == int(self.jh.window_pos), note
        for name, a, b in zip(tsim.ReconfigProposal._fields + tsim.ReadReceipt._fields,
                              tuple(tprop) + tuple(trec), tuple(jprop) + tuple(jrec)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{note}: {name}")
        return tprop, trec

    def leaders(self):
        return self.tst.leader_id.amax(0).numpy()


def warmed(p, g, damped, linked, voters=None, learners=None):
    """A pair after WARM_ROUNDS null rounds of one append a group, memoized
    per configuration (each test steps its own copy)."""
    key = (p, g, damped, linked, tuple(voters or ()), tuple(learners or ()))
    if key not in _WARM:
        pair = Pair(p, g, damped, linked, voters, learners)
        for r in range(WARM_ROUNDS):
            pair.round(r, np.zeros((p, g), bool), np.ones(g, np.int32))
        _WARM[key] = pair
    return _WARM[key].copy()


def run_schedule(schedule, rounds, p=P, g=G, damped=False, linked=False, **masks):
    """Both packages through `schedule(r, pair) -> (crashed [G, P] or None,
    tp [G] or None, kick [G, P] or None, link [P, P, G] or None)` from the
    warmed pair, compared every round; returns the pair and the rounds
    whose proposals a transfer blocked."""
    pair = warmed(p, g, damped, linked, **masks)
    blocked_rounds = 0
    for r in range(WARM_ROUNDS, rounds):
        crashed, tp, kick, link = schedule(r, pair)
        if link is not None and not pair.linked:
            continue  # a link schedule runs on the link-gated round only
        crashed = np.zeros((p, g), bool) if crashed is None else crashed.T.copy()
        kick = None if kick is None else kick.T.copy()
        prop, _ = pair.round(r, crashed, np.ones(g, np.int32), link, tp, kick)
        # A round whose acting leaders proposed nothing: a transfer blocked.
        leads = kfn(tk, "acting_leader_id")(pair.tst.state, pair.tst.term,
                                            torch.from_numpy(crashed))
        blocked_rounds += int((leads > 0).sum() > (prop.owner > 0).sum())
    return pair, blocked_rounds


def _targets(pair, swap=(2, 1)):
    lead = pair.leaders()
    return np.where(lead == 1, swap[0], swap[1]).astype(np.int32)


# --- the schedules of tests/test_transfer_batched.py ------------------------


def sched_basic(r, pair):
    tp = None
    if r == 22:
        tp = pair.captured = _targets(pair)
    return None, tp, None, None


def sched_lagging(r, pair):
    crashed = tp = None
    if 14 <= r < 20:
        crashed = np.zeros((pair.g, pair.p), bool)
        crashed[:, 2] = True
    if r == 22:
        tp = np.where(pair.leaders() == 3, 0, 3).astype(np.int32)
    return crashed, tp, None, None


def sched_crashed_target(r, pair):
    crashed = tp = None
    if 20 <= r < 40:
        crashed = np.zeros((pair.g, pair.p), bool)
        crashed[:, 2] = True
    if r == 21:
        tp = np.where(pair.leaders() == 3, 0, 3).astype(np.int32)
    return crashed, tp, None, None


def sched_override(r, pair):
    tp = link = None
    if 20 <= r < 32:
        link = np.ones((pair.p, pair.p, pair.g), bool)
        link[:, 2, :] = False
        link[2, :, :] = False
        lead = pair.leaders()
        if r == 21:
            tp = np.where(lead == 3, 0, 3).astype(np.int32)
        if r == 25:
            tp = np.where(lead == 1, 2, np.where(lead == 2, 1, 0)).astype(np.int32)
    return None, tp, None, link


def sched_learner(r, pair):
    return None, np.full(pair.g, 3, np.int32) if r == 20 else None, None, None


def sched_mid_partition(r, pair):
    tp = link = None
    if 20 <= r < 32:
        link = np.ones((pair.p, pair.p, pair.g), bool)
        link[0, 2, :] = link[2, 0, :] = False
        link[1, 2, :] = link[2, 1, :] = False
        if r == 21:
            tp = _targets(pair)
    return None, tp, None, link


def sched_one_way_cut(r, pair):
    tp = link = None
    if 20 <= r < 30:
        link = np.ones((pair.p, pair.p, pair.g), bool)
        link[1, 0, :] = False  # 2 -> 1 down
        if r == 21:
            tp = _targets(pair)
    return None, tp, None, link


def sched_kick(r, pair):
    crashed = kick = None
    if 20 <= r < 34:
        crashed = np.zeros((pair.g, pair.p), bool)
        crashed[:, 0] = True
    if r == 22:
        kick = np.zeros((pair.g, pair.p), bool)
        kick[:, 1] = True
    return crashed, None, kick, None


def sched_damped_kick(r, pair):
    tp = kick = crashed = None
    if r == 22:
        tp = _targets(pair)
    if 26 <= r < 36:
        crashed = np.zeros((pair.g, pair.p), bool)
        crashed[:, 0] = True
    if r == 29:
        kick = np.zeros((pair.g, pair.p), bool)
        kick[:, 1] = True
    return crashed, tp, kick, None


UNDAMPED = {
    "basic": (sched_basic, 28, {}),
    "lagging": (sched_lagging, 30, {}),
    "crashed_target": (sched_crashed_target, 40, {}),
    "override": (sched_override, 36, {}),
    "learner": (sched_learner, 26, {"voters": [1, 2], "learners": [3]}),
    "mid_partition": (sched_mid_partition, 36, {}),
    "one_way_cut": (sched_one_way_cut, 34, {}),
    "kick": (sched_kick, 38, {}),
}
LINK_SCHEDULES = ("override", "mid_partition", "one_way_cut")


@pytest.mark.parametrize("name", [n for n in UNDAMPED if n not in LINK_SCHEDULES])
def test_transfer_schedules_plain_round(name):
    schedule, rounds, masks = UNDAMPED[name]
    pair, blocked = run_schedule(schedule, rounds, **masks)
    tr = pair.tst.transferee
    if name == "basic":
        assert (pair.leaders() == pair.captured).all()
        assert not tr.any()
    if name == "crashed_target":
        assert blocked > 0, "a pending transfer never dropped a proposal"
        assert not tr.any(), "the tick-time abort never cleared the transfer"
    if name == "lagging":
        assert (pair.leaders() == 3).any()
    if name == "learner":
        assert not tr.any() and blocked == 0


@pytest.mark.parametrize("name", list(UNDAMPED))
def test_transfer_schedules_link_gated_round(name):
    schedule, rounds, masks = UNDAMPED[name]
    pair, _ = run_schedule(schedule, rounds, linked=True, **masks)
    if name in ("basic", "kick"):
        assert (pair.leaders() > 0).all()


@pytest.mark.parametrize("name", ["damped_kick", "basic", "crashed_target"])
def test_transfer_schedules_damped_round(name):
    schedule = {"damped_kick": sched_damped_kick, "basic": sched_basic,
                "crashed_target": sched_crashed_target}[name]
    rounds = {"damped_kick": 40, "basic": 28, "crashed_target": 40}[name]
    pair, blocked = run_schedule(schedule, rounds, damped=True)
    if name == "crashed_target":
        assert blocked > 0


def test_transfer_and_kick_at_five_peers():
    """P=5 on the link-gated round (the autopilot's path): a transfer to
    each group's next peer, then a crashed leader healed by kicks."""

    def schedule(r, pair):
        crashed = tp = kick = None
        if r == 20:
            tp = (pair.leaders() % pair.p + 1).astype(np.int32)
        if 24 <= r < 34:
            crashed = np.zeros((pair.g, pair.p), bool)
            crashed[:, 3] = True
        if r == 27:
            kick = np.zeros((pair.g, pair.p), bool)
            kick[:, 0] = True
        return crashed, tp, kick, None

    pair, _ = run_schedule(schedule, 36, p=5, linked=True)
    assert int(pair.tctr[tk.CTR_ELECTIONS_WON]) > 0


def test_transfer_pending_degrades_lease_read():
    """tests/test_read_lease.py's case through both packages on the damped
    round: the target crashed, the command's round still serves by lease
    (the read probes the round-entry state), and the next round's lease
    read degrades to the quorum round while the transfer is pending."""
    pair = warmed(P, G, True, True)
    app = np.zeros(G, np.int32)
    for r in range(WARM_ROUNDS, 30):  # settle the pre-vote elections
        pair.round(r, np.zeros((P, G), bool), app)
    lead = pair.tst.state.argmax(0).numpy()
    tgt = ((lead + 1) % P + 1).astype(np.int32)
    crashed = np.zeros((P, G), bool)
    crashed[tgt - 1, np.arange(G)] = True
    lease = np.full(G, tsim.READ_LEASE, np.int32)
    _, receipt = pair.round(30, crashed, app, tp=tgt, read=lease)
    served = receipt.lease
    assert served.sum() >= G - 1
    assert (pair.tst.transferee.amax(0)[served].numpy() == tgt[served.numpy()]).all()
    _, receipt = pair.round(31, crashed, app, read=lease)
    assert receipt.degraded[served].all() and (receipt.index[served] >= 0).all()
    # The lease gate itself, on the pending state, in both packages.
    jst, tst = pair.jst, pair.tst
    no = np.zeros((P, G), bool)
    want = kfn(jk, "lease_read")(
        jst.state, jst.term, jst.leader_id, jst.election_elapsed, jst.commit,
        jst.term_start_index, jnp.asarray(no), 10, True, jst.transferee,
        jst.recent_active, jst.voter_mask, jst.outgoing_mask)
    got = kfn(tk, "lease_read")(
        tst.state, tst.term, tst.leader_id, tst.election_elapsed, tst.commit,
        tst.term_start_index, torch.from_numpy(no), 10, True, tst.transferee,
        tst.recent_active, tst.voter_mask, tst.outgoing_mask)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[1].any(), "a pending transfer must reject the lease"


# --- the kernels ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_apply_transfer_matches_jax_on_random_planes(seed):
    p, g = (3, 5, 5, 7)[seed], 32
    rng = np.random.default_rng(seed)
    transferee = np.where(rng.random((p, g)) < 0.3, rng.integers(1, p + 1, (p, g)),
                          0).astype(np.int32)
    ee = rng.integers(0, 20, (p, g)).astype(np.int32)
    lead = rng.integers(0, p + 1, g)  # 0: no acting leader
    acting = np.arange(1, p + 1)[:, None] == lead[None, :]
    propose = rng.integers(0, p + 1, g).astype(np.int32)
    # Some commands name the current target or the leader itself.
    cur = (transferee * acting).sum(0).astype(np.int32)
    propose = np.where(rng.random(g) < 0.2, cur, propose)
    propose = np.where(rng.random(g) < 0.15, lead, propose).astype(np.int32)
    member = rng.random((p, g)) < 0.8
    learner = member & (rng.random((p, g)) < 0.25)
    args = (transferee, ee, acting, propose, member, learner)
    want = kfn(jk, "apply_transfer")(*(jnp.asarray(a) for a in args))
    got = kfn(tk, "apply_transfer")(*(torch.from_numpy(a) for a in args))
    for n, (w, t, dt) in enumerate(zip(want, got, (torch.int32, torch.int32, torch.bool))):
        assert t.dtype == dt, n
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=f"output {n}")
    assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()


def test_apply_transfer_validation_rules():
    """tests/test_transfer_batched.py's cases: member, learner and self
    checks, the same-target no-op, and the abort-on-self quirk."""
    g, p = 6, 4
    acting = np.tile(np.array([[True], [False], [False], [False]]), (1, g))
    member = np.ones((p, g), bool)
    member[3] = False
    learner = np.zeros((p, g), bool)
    learner[2] = True
    transferee = np.zeros((p, g), np.int32)
    transferee[0, 4] = transferee[0, 5] = 2
    ee = np.full((p, g), 7, np.int32)
    propose = np.asarray([2, 3, 1, 4, 2, 1], np.int32)
    args = (transferee, ee, acting, propose, member, learner)
    want = kfn(jk, "apply_transfer")(*(jnp.asarray(a) for a in args))
    t2, ee2, accepted = kfn(tk, "apply_transfer")(*(torch.from_numpy(a) for a in args))
    for w, t in zip(want, (t2, ee2, accepted)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert accepted.tolist() == [True, False, False, False, False, False]
    assert t2[0].tolist() == [2, 0, 0, 0, 2, 0]
    assert ee2[0].tolist() == [0, 7, 7, 7, 7, 7]


@pytest.mark.parametrize("seed", range(3))
def test_apply_confchange_transferee_arm_matches_jax(seed):
    p, g = (3, 5, 7)[seed], 24
    rng = np.random.default_rng(40 + seed)

    def b(q, shape=(p, g)):
        return rng.random(shape) < q

    def i(hi, shape=(p, g)):
        return rng.integers(0, hi, shape).astype(np.int32)

    args = [i(4), i(p + 1), i(12), i(6), i(30, (p, p, g)), b(0.6), b(0.3), b(0.2),
            b(0.6), b(0.3), b(0.2), b(0.2), b(0.2), b(0.7, (g,)), b(0.5, (p, p, g)),
            np.where(b(0.5), rng.integers(1, p + 1, (p, g)), 0).astype(np.int32)]
    want = kfn(jk, "apply_confchange")(*(jnp.asarray(a) for a in args))
    got = kfn(tk, "apply_confchange")(*(torch.from_numpy(a) for a in args))
    for n, (w, t) in enumerate(zip(want, got)):
        w = np.asarray(w)
        assert t.numpy().dtype == w.dtype, n
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f"output {n}")
    assert (np.asarray(want[8]) != args[15]).any() and np.asarray(want[8]).any()


def test_apply_confchange_aborts_removed_transferee():
    """tests/test_transfer_batched.py's case: removing the pending target
    from the voters aborts the transfer in the applied groups only."""
    g = 3
    state = np.tile([[2], [0], [0]], (1, g)).astype(np.int32)
    leader_id = np.ones((3, g), np.int32)
    commit = np.full((3, g), 5, np.int32)
    ts = np.full((3, g), 4, np.int32)
    matched = np.full((3, 3, g), 5, np.int32)
    vm, om, lm = np.ones((3, g), bool), np.zeros((3, g), bool), np.zeros((3, g), bool)
    transferee = np.zeros((3, g), np.int32)
    transferee[0] = 3
    tgt_v = np.tile([[True], [True], [False]], (1, g))
    no = np.zeros((3, g), bool)
    removed = np.tile([[False], [False], [True]], (1, g))
    apply_mask = np.asarray([True, False, True])
    args = (state, leader_id, commit, ts, matched, vm, om, lm, tgt_v, no, no, no,
            removed, apply_mask)
    want = kfn(jk, "apply_confchange")(*(jnp.asarray(a) for a in args), None,
                                       jnp.asarray(transferee))
    got = kfn(tk, "apply_confchange")(*(torch.from_numpy(a) for a in args), None,
                                      torch.from_numpy(transferee))
    np.testing.assert_array_equal(got[8].numpy(), np.asarray(want[8]))
    assert got[8][0].tolist() == [0, 3, 0]


def test_transfer_off_state_and_refusal():
    """A transfer-off state keeps transferee=None through every round, and a
    transfer command without the plane fails as in the reference."""
    cfg = tsim.SimConfig(n_groups=4, n_peers=3)
    st = tsim.init_state(cfg, device="cpu")
    assert st.transferee is None
    crashed, append = torch.zeros((3, 4), dtype=torch.bool), torch.ones(4, dtype=torch.int32)
    assert tsim.step(cfg, st, crashed, append).transferee is None
    with pytest.raises(ValueError, match=r"SimConfig\(transfer=True\)"):
        tsim.step(cfg, st, crashed, append, transfer_propose=torch.zeros(4, dtype=torch.int32))
    back = tsim.state_from_numpy(tsim.state_to_numpy(
        tsim.init_state(cfg._replace(transfer=True), device="cpu")), "cpu")
    assert back.transferee.dtype == torch.int32 and not back.transferee.any()


# --- the fused path on transfer-on states ----------------------------------------


def test_steady_mask_rejects_pending_transfer():
    """A pending transfer anywhere in a group rejects it, in both packages;
    an all-zero plane rejects nothing."""
    pair = warmed(P, G, False, False)
    jcfg, tcfg = pair.jcfg, pair.tcfg
    crashed = np.zeros((P, G), bool)

    def both(plane):
        jst = pair.jst._replace(transferee=jnp.asarray(plane))
        tst = pair.tst._replace(transferee=torch.from_numpy(plane))
        want = np.asarray(jps.steady_mask(jcfg, jst, jnp.asarray(crashed), horizon=4))
        got = tfs.steady_mask(tcfg, tst, torch.from_numpy(crashed), horizon=4)
        np.testing.assert_array_equal(got.numpy(), want)
        return want

    base = both(np.zeros((P, G), np.int32))
    pick = np.flatnonzero(base)[:2]
    assert len(pick) == 2, "the warmed fleet should have steady groups"
    tr = np.zeros((P, G), np.int32)
    tr[0, pick[0]] = 2
    tr[2, pick[1]] = 1
    rejected = np.zeros(G, bool)
    rejected[pick] = True
    assert (both(tr) == base & ~rejected).all()


def _general(cfg, st, crashed, append, k, link=None, loss=None, r0=0):
    for r in range(k):
        kw = {}
        if link is not None:
            kw["link"] = link & ~kfn(tk, "link_loss_draw")(r0 + r, loss)
        st = tsim.step(cfg, st, crashed, append, **kw)
    return st


@pytest.mark.parametrize("kind", ["steady", "chaos", "damped", "hybrid"])
def test_fused_wrappers_carry_the_transferee_plane(kind):
    """From a settled transfer-on state (no transfer pending), each fused
    wrapper equals k general rounds on every plane, the transferee plane
    included, which it passes through untouched; hybrid_multi_round's split
    branch gathers and merges it with the rest."""
    k = 4
    damped = kind == "damped"
    _, cfg = pair_cfg(P, G, damped)
    cfg = cfg._replace(collect_counters=False, collect_health=False, election_tick=16,
                       lease_read=False)
    st = tsim.init_state(cfg, device="cpu")
    crashed = torch.zeros((P, G), dtype=torch.bool)
    append = torch.ones(G, dtype=torch.int32)
    st = _general(cfg, st, crashed, append, 60)
    assert tfs.steady_mask(cfg, st, crashed, horizon=k).all()
    if kind == "chaos":
        link = torch.ones((P, P, G), dtype=torch.bool)
        loss = torch.zeros((P, P, G), dtype=torch.int32)
        out = tfs.chaos_round(cfg, k)(st, crashed, append, loss, 60)
        want = _general(cfg, st, crashed, append, k, link, loss, 60)
    elif kind == "hybrid":
        crashed = crashed.clone()
        crashed[st.state[:, 3].argmax(), 3] = True  # group 3 storms
        fn = tfs.hybrid_multi_round(cfg, k, storm_slots=2, device="cpu")
        out = fn(st, crashed, append)
        assert fn.last_branch == "split"
        want = _general(cfg, st, crashed, append, k)
    else:
        out = (tfs.damped_round if damped else tfs.steady_round)(cfg, k)(st, crashed, append)
        want = _general(cfg, st, crashed, append, k)
    if kind != "hybrid":
        assert out.transferee is st.transferee
    for f in tsim.SimState._fields:
        a, b = getattr(out, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
