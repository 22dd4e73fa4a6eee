"""The check: the frozen reference equals the program's round, a sound run
is correct, and the control and every planted fault are not."""

import time

import numpy as np
import pytest
import torch

from portbench import check, controls, harness
from portbench.reference import raft_step as R


@pytest.mark.parametrize("damped", [False, True])
def test_reference_equals_the_programs_round(damped):
    from raft_tpu_torch.multiraft import sim

    G, P = 400, 3
    kw = dict(election_tick=10, heartbeat_tick=2 if damped else 1,
              check_quorum=damped, pre_vote=damped)
    pc, rc = sim.SimConfig(n_groups=G, n_peers=P, **kw), R.Config(G, P, **kw)
    ps, rs = sim.init_state(pc, device="cpu"), R.init_state(rc, "cpu")
    assert check.mismatch(ps, rs) == 0
    rng = np.random.default_rng(3)
    for r in range(120):
        app = torch.from_numpy(np.minimum(rng.zipf(1.8, G), 8).astype(np.int32))
        on = (np.arange(G)[None] + np.arange(P)[:, None]) % 30 == (r // 40) % 30
        crashed = torch.from_numpy(on & (r % 40 < 14))
        if r == 90:
            ps, rs = sim.init_state(pc, device="cpu"), R.init_state(rc, "cpu")
        ps, rs = sim.step(pc, ps, crashed, app), R.step(rc, rs, crashed, app)
        assert check.mismatch(ps, rs) == 0, r
        assert check.guarantee_violations(rs) == 0
    idx = torch.tensor([3, 77, 399])
    sub = R.State(*[None if v is None else v[..., idx] for v in rs])
    whole = R.step(rc, rs, crashed, app)
    part = R.step(rc._replace(n_groups=3), sub, crashed[:, idx], app[idx], group_ids=idx)
    assert check.mismatch(R.State(*[None if v is None else v[..., idx] for v in whole]),
                          part) == 0


def run(workload, system=None, seed=2**31 + 7, seconds=0.6, n_groups=300):
    return harness.run_cell(workload, seed, seconds, False, t0=time.perf_counter(),
                            device="cpu", system=system, n_groups=n_groups)


CELLS = ["raftrs-1m-r3.ycsb", "tikv-1m-r3.ycsb", "tikv-1m-r3.store-loss", "raftrs-1m-r3.storm"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", ["raftrs-1m-r3.ycsb", "tikv-1m-r3.store-loss"])
def test_control_is_not_correct(workload):
    r = run(workload, controls.Control)
    assert not r["correct"]
    for name in ("settle_mismatch", "block_mismatch", "guarantee_violations"):
        assert r["checks"][name]["value"] > 0, name


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["raftrs-1m-r3.ycsb", "tikv-1m-r3.ycsb"])
def test_planted_fault_is_not_correct(workload, fault):
    r = run(workload, controls.SYSTEMS[fault])
    assert not r["correct"], (fault, r["checks"])


def test_settle_fault_is_caught_by_the_start_check():
    class BadSettle(controls.Program):
        def step(self, st, crashed, append):
            out = super().step(st, crashed, append)
            return out._replace(vote=out.vote * 0 + 1)

    r = run("raftrs-1m-r3.ycsb", BadSettle)
    assert r["checks"]["settle_mismatch"]["value"] > 0 and not r["correct"]


def test_a_stall_in_the_window_moves_every_end_to_end_metric():
    class Stall(controls.Program):
        """Sleeps in each block that starts from a restarted fleet."""

        def block(self, st, crashed, append, fused):
            if int(st.term.max()) == 0:
                time.sleep(0.4)
            return super().block(st, crashed, append, fused)

    seed = 2**31 + 99
    base = run("raftrs-1m-r3.storm", seed=seed, seconds=1.5)["metrics"]
    slow = run("raftrs-1m-r3.storm", Stall, seed=seed, seconds=1.5)["metrics"]
    v = lambda m, n: m[n]["value"]  # noqa: E731
    assert v(slow, "ticks_per_s") < v(base, "ticks_per_s")
    assert v(slow, "step_ms_p95") > v(base, "step_ms_p95") + 300
    assert v(slow, "recover_ms_p95") > v(base, "recover_ms_p95") + 300
