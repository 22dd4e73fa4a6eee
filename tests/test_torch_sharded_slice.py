"""This slice's sharded scenarios on two gloo CPU ranks against the JAX
package's ClusterSim(mesh=make_mesh(2)), exactly: the production split
plan (examples/reconfig/prod_fused.json at G=256 after the 192-round
settle: health, check-quorum, pre-vote, a lossy chaos overlay and the k=8
split runner, fused_frac included; against the reference unsharded, as
its mesh run of the split runner raises under this JAX), one chaos and one
reconfig golden scenario, and the `--mesh 2 --device cpu` bench line against bench.py's
`--mesh 2` on every field not derived from time.  The whole golden corpora
and four ranks are slow, as the reference marks its corpus cases.  The
ranks run raft_tpu_torch.tools.sharded_parity_report.replay."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.multiraft import ClusterSim as JClusterSim
from raft_tpu.multiraft import SimConfig as JSimConfig
from raft_tpu.multiraft import chaos as jchaos
from raft_tpu.multiraft import reconfig as jrc
from raft_tpu.multiraft import sharding as jsh
from raft_tpu_torch import bench as port
from raft_tpu_torch.multiraft import sharding
from raft_tpu_torch.tools import sharded_parity_report as spr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
PROD = os.path.join(REPO, "examples", "reconfig", "prod_fused.json")


def assert_equal_to_reference(got: dict, js, tag: str):
    for name in js.state._fields:
        w = getattr(js.state, name)
        if w is None:
            assert name not in got["state"], f"{tag}:{name}"
            continue
        np.testing.assert_array_equal(got["state"][name], np.asarray(w), err_msg=f"{tag}:{name}")
    np.testing.assert_array_equal(got["health"], np.asarray(js._health.planes),
                                  err_msg=f"{tag}:health")


def prod_spec(G: int) -> dict:
    with open(PROD, encoding="utf-8") as f:
        doc = json.load(f)
    plan = jrc.plan_from_dict(doc["reconfig"])
    masks = [np.asarray(m) for m in jrc.initial_masks(plan, G)]
    return {
        "cfg": dict(n_groups=G, n_peers=plan.n_peers, election_tick=64,
                    collect_health=True, check_quorum=True, pre_vote=True),
        "masks": masks,
        "ops": [("run_compiled", 3 * 64, np.ones(G, np.int32)),
                ("run_reconfig", doc["reconfig"], doc["chaos"],
                 {"split": True, "split_k": 8})],
    }, doc


def golden(corpus: str, index: int) -> dict:
    with open(os.path.join(REPO, "tests", "testdata", corpus, "plans.json"),
              encoding="utf-8") as f:
        return json.load(f)[index]


@pytest.fixture(scope="module")
def sharded():
    spec, _ = prod_spec(256)
    chaos_doc, reconfig_doc = golden("chaos", 0), golden("reconfig", 0)
    specs = spr.scenario_specs(32)
    runs = [spec, specs["chaos"][chaos_doc["name"]],
            specs["reconfig"][reconfig_doc["reconfig"]["name"]]]
    return sharding.launch(2, spr.replay_each, runs, devices=[CPU, CPU])


def test_split_prod_plan_equals_reference(sharded):
    spec, doc = prod_spec(256)
    G = 256
    plan, cplan = jrc.plan_from_dict(doc["reconfig"]), jchaos.plan_from_dict(doc["chaos"])
    cfg = JSimConfig(**spec["cfg"])
    vm, om, lm = jrc.initial_masks(plan, G)
    # The reference's own mesh run of the split plan raises under this JAX
    # (its pallas_call refuses a mesh whose axes are not Manual), so the
    # reference side is its unsharded run, which its sharded-parity test
    # holds equal to the mesh run where that runs.
    js = JClusterSim(cfg, voter_mask=vm, outgoing_mask=om, learner_mask=lm)
    js.run_compiled(3 * 64, append_n=jnp.ones((G,), jnp.int32))
    want = js.run_reconfig(plan, chaos_plan=cplan, split=True, split_k=8)
    got = sharded[0]
    assert_equal_to_reference(got, js, "prod-fused")
    assert got["results"][1] == want
    assert want["fused_frac"] > 0.5, want["fused_frac"]


@pytest.mark.parametrize("corpus", ["chaos", "reconfig"])
def test_golden_scenario_equals_reference_mesh(sharded, corpus):
    G = 32
    if corpus == "chaos":
        doc = golden("chaos", 0)
        plan = jchaos.plan_from_dict(doc)
        js = JClusterSim(JSimConfig(n_groups=G, n_peers=plan.n_peers, collect_health=True),
                         mesh=jsh.make_mesh(2), chaos=plan)
        want, got = js.run_plan(), sharded[1]
    else:
        doc = golden("reconfig", 0)
        plan = jrc.plan_from_dict(doc["reconfig"])
        vm, om, lm = jrc.initial_masks(plan, G)
        js = JClusterSim(JSimConfig(n_groups=G, n_peers=plan.n_peers, collect_health=True),
                         voter_mask=vm, outgoing_mask=om, learner_mask=lm,
                         mesh=jsh.make_mesh(2))
        want = js.run_reconfig(plan, chaos_plan=jchaos.plan_from_dict(doc["chaos"]))
        got = sharded[2]
    assert_equal_to_reference(got, js, corpus)
    assert got["results"][-1] == want
    assert not any(want["safety"].values())


@pytest.mark.slow
@pytest.mark.parametrize("ranks", [2, 4])
def test_whole_golden_corpora_sharded_equal_unsharded(ranks):
    """Every scenario of both corpora on `ranks` CPU ranks equals the port
    unsharded (which test_torch_chaos_run and test_torch_reconfig_slice
    hold to the reference), with zero safety counts: the parity tool."""
    assert spr.main(["--groups", "64", "--ranks", str(ranks), "--device", CPU]) == 0


TIMED = {"value", "min", "median", "max", "spread_pct", "spread_flagged",
         "per_chip_ticks_per_sec"}


def untimed(line: dict) -> dict:
    return {k: v for k, v in line.items() if k not in TIMED}


def test_mesh_bench_line_equals_reference(capsys, monkeypatch):
    import bench as ref

    G = 32
    # bench.py --mesh pins the virtual CPU platform's device count in the
    # environment; keep that to this test.
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setenv("JAX_PLATFORMS", os.environ.get("JAX_PLATFORMS", "cpu"))
    monkeypatch.setattr(sys, "argv", ["bench.py", "--groups", str(G), "--reps", "1",
                                      "--mesh", "2"])
    capsys.readouterr()
    ref.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = port.main(["--device", CPU, "--groups", str(G), "--reps", "1", "--mesh", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    assert set(got) == set(want)
    assert untimed(got) == untimed(want)
    assert got["n_devices"] == 2 and got["n_leaders"] == G and got["total_commit"] > 0


def test_mesh_bench_refuses_more_ranks_than_cards(capsys):
    if port.torch.cuda.is_available():
        n = port.torch.cuda.device_count() + 1
    else:
        n = 2
    with pytest.raises(SystemExit) as exc:
        port.main(["--groups", "32", "--reps", "1", "--mesh", str(n)])
    assert exc.value.code == 2


@pytest.mark.slow
def test_reads_and_damped_packed_carry_equal_reference_mesh():
    """The client workload (Zipf writes, lease and Safe reads) under a lossy
    chaos overlay, and the damped run_compiled whose recent_active rides the
    carry packed, on 2 ranks against the reference (test_sharded_parity.py's
    slow cases): the damped run against its mesh, the reads against its
    unsharded run, as its mesh run_reads raises under this JAX."""
    from raft_tpu.multiraft import workload as jwl

    reads_kw = dict(n_groups=64, n_peers=3, collect_health=True, check_quorum=True,
                    lease_read=True)
    plan = {"name": "sharded-reads", "peers": 3, "seed": 5, "phases": [
        {"rounds": 12, "append": 1},
        {"rounds": 16, "read_every": 2, "read_mode": "lease", "write_zipf": 1.8},
        {"rounds": 12, "read_every": 3, "read_mode": "safe"}]}
    cplan = {"name": "overlay", "peers": 3, "phases": [
        {"rounds": 20, "loss_all": 0.02}, {"rounds": 20}]}
    damped_kw = dict(n_groups=256, n_peers=3, check_quorum=True, pre_vote=True)
    specs = [{"cfg": reads_kw, "ops": [("run_reads", plan, cplan, None, {})]},
             {"cfg": damped_kw, "ops": [("run_compiled", 24, np.ones(256, np.int32))]}]
    got = sharding.launch(2, spr.replay_each, specs, devices=[CPU, CPU])
    js = JClusterSim(JSimConfig(**reads_kw))
    want = js.run_reads(jwl.plan_from_dict(plan), chaos_plan=jchaos.plan_from_dict(cplan))
    assert_equal_to_reference(got[0], js, "reads")
    assert got[0]["results"][0] == want
    jd = JClusterSim(JSimConfig(**damped_kw), mesh=jsh.make_mesh(2))
    jd.run_compiled(24, append_n=jnp.ones((256,), jnp.int32))
    for name in jd.state._fields:
        w = getattr(jd.state, name)
        if w is not None:
            np.testing.assert_array_equal(got[1]["state"][name], np.asarray(w), err_msg=name)
