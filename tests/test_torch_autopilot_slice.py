"""This slice's fused cadence runner end to end against the JAX package on
the CPU, exactly: the port's `autopilot.make_cadence_runner(fused=True)`
against the reference's (`interpret=True`: its fused segments run the
Pallas kernels in interpret mode, a k=16 build each), undamped (the chaos
kernel's with_health instance, as `bench.py --autopilot` runs it) and
damped (the damped kernel's with_loss with_health instance), segment by
segment over a plan with steady stretches, a segment carrying transfer
commands, a crash and a heal: every output and the fused count.  Then
`Autopilot.run_plan(fused=True)` against `fused=False` and against the
reference's fused run, and tests/test_autopilot.py's evacuation case at
P=5, G=16."""

import numpy as np
import pytest
import torch

from raft_tpu_torch.multiraft import autopilot as tap
from raft_tpu_torch.multiraft import chaos as tchaos
from raft_tpu_torch.multiraft import sim as tsim

from test_torch_autopilot import _run_both, run_segments
from test_torch_sim import assert_states_equal

K = 16
TICK = 64  # the free-running election bound must clear the k=16 horizon
SLICE_PLAN = {
    "name": "slice", "peers": 3,
    "phases": [
        {"rounds": 48, "append": 1},
        {"rounds": 16, "crash": [3], "append": 1},
        {"rounds": 32, "heal": True, "append": 1},
    ],
}
LONG_HEAL = {
    "name": "long-heal", "peers": 3,
    "phases": [
        {"rounds": 96, "append": 1},
        {"rounds": 16, "crash": [2, 3], "append": 1},
        {"rounds": 48, "heal": True, "append": 1},
    ],
}


def slice_actions(G):
    """Transfer commands to the next peer in half the groups in segment 2
    (a steady stretch the actions keep general); no action elsewhere."""
    def actions(seg, st):
        transfer = np.zeros(G, np.int32)
        if seg == 2:
            lead = st.leader_id.amax(0).numpy()
            transfer[::2] = lead[::2] % 3 + 1
        return transfer, np.zeros((3, G), bool)
    return actions


@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_fused_cadence_runner_matches_jax(damped):
    counts = run_segments(8, K, True, slice_actions(8), settle=3 * TICK,
                          plan=SLICE_PLAN, election_tick=TICK,
                          check_quorum=damped, pre_vote=damped)
    # The steady stretches fuse; the action and crash segments cannot.
    assert counts[0] == counts[1] == K * 8
    assert counts[2] == counts[3] == 0


def test_fused_run_plan_equals_general_and_jax():
    """tests/test_autopilot.py's fused case: the crash takes out a voter
    majority while some leaders stay alive, which the progress guard must
    send down the general path."""
    kw = dict(G=16, cadence=K, plan=LONG_HEAL, election_tick=TICK)
    fused = _run_both(fused=True, **kw)
    assert fused["fused_frac"] > 0
    cfg = tsim.SimConfig(n_groups=16, n_peers=3, collect_health=True, transfer=True,
                         election_tick=TICK, commit_stall_ticks=8)
    sims = []
    for flag in (True, False):
        sim = tsim.ClusterSim(cfg, device="cpu")
        rep = tap.Autopilot(sim, tap.AutopilotConfig(cadence=K), fused=flag).run_plan(
            tchaos.plan_from_dict(LONG_HEAL))
        sims.append((sim, rep))
    (fs, fr), (gs, gr) = sims
    assert fr == fused
    assert_states_equal(gs.state, fs.state, "fused against general")
    assert torch.equal(fs._health.planes, gs._health.planes)
    for key in ("fused_rounds", "total_rounds", "fused_frac"):
        fr.pop(key)
    assert fr == gr


def test_evacuation_through_the_reconfig_protocol():
    """tests/test_autopilot.py's evacuation case at P=5, G=16 (voters 1-3,
    voter 3 crashed for 40 rounds): the same report, actions and end state
    as the reference, the evacuated groups' configs walked off voter 3
    onto the spare."""
    doc = {"name": "evac", "peers": 5, "phases": [
        {"rounds": 24, "append": 1}, {"rounds": 40, "crash": [3], "append": 1},
        {"rounds": 16, "heal": True, "append": 1}]}
    import jax.numpy as jnp
    from raft_tpu.multiraft import ClusterSim as JClusterSim
    from raft_tpu.multiraft import autopilot as jap
    from raft_tpu.multiraft import chaos as jchaos
    from raft_tpu.multiraft import sim as jsim

    G = 16
    kw = dict(n_groups=G, n_peers=5, collect_health=True, transfer=True,
              commit_stall_ticks=8)
    apkw = dict(cadence=8, evacuate=True, evac_stall_ticks=8, evac_min_groups=2)
    vm = np.zeros((5, G), bool)
    vm[:3] = True
    js = JClusterSim(jsim.SimConfig(**kw), voter_mask=jnp.asarray(vm))
    want = jap.Autopilot(js, jap.AutopilotConfig(**apkw)).run_plan(jchaos.plan_from_dict(doc))
    ts = tsim.ClusterSim(tsim.SimConfig(**kw), voter_mask=torch.from_numpy(vm), device="cpu")
    got = tap.Autopilot(ts, tap.AutopilotConfig(**apkw)).run_plan(tchaos.plan_from_dict(doc))
    assert got == want
    assert_states_equal(js.state, ts.state, "end state")
    assert not any(got["safety"].values()) and got["actions"]["evacuations"] > 0
    vm2 = ts.state.voter_mask.numpy()
    evacuated = ~vm2[2] & vm2[3]
    assert evacuated.sum() == got["actions"]["evacuations"]
    assert not ts.state.outgoing_mask.numpy()[:, evacuated].any()
