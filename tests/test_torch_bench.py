"""The port's bench entry point (`python -m raft_tpu_torch.bench`): the
perf-regression gate (--check) ported case by case from test_bench_check.py
against the port's own gate and keys, the keys' separation from the JAX
package's baseline entries, the flag checks, --mesh left to the multi-GPU
slice, the cuda default, --profile's trace, and profiling.RoundTimer
against the reference's.  Host-side logic and small CPU runs only."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raft_tpu_torch import bench, profiling

ROOT = Path(__file__).resolve().parent.parent


def line(metric="raft_ticks_per_sec_100k_groups_5_peers", median=900e6,
         groups=bench.G, flagged=False):
    return {
        "metric": metric,
        "median": median,
        "groups": groups,
        "reps": 5,
        "spread_pct": 5.0,
        "spread_flagged": flagged,
    }


def key(metric="raft_ticks_per_sec_100k_groups_5_peers", groups=bench.G,
        device="cuda"):
    return f"{metric}@torch-{device}@g{groups}"


def args_for(check, check_out="", threshold=None, update=False, device="cuda"):
    return argparse.Namespace(
        check=str(check), check_out=str(check_out) if check_out else "",
        check_threshold=threshold, update_baseline=update, device=device,
    )


def test_check_passes_within_threshold():
    baseline = {key(): {"median": 1000e6, "threshold_pct": 15.0}}
    ok, verdict = bench.check_against_baseline(line(median=900e6), baseline)
    assert ok and verdict["status"] == "ok"


def test_check_fails_on_regression():
    """A synthetic baseline far above the measured median fails the gate."""
    baseline = {key(): {"median": 1e15, "threshold_pct": 15.0}}
    ok, verdict = bench.check_against_baseline(line(median=900e6), baseline)
    assert not ok and verdict["status"] == "regressed"


def test_check_spread_flag_is_the_validity_check():
    baseline = {key(): {"median": 1e15, "threshold_pct": 15.0}}
    ok, verdict = bench.check_against_baseline(
        line(median=900e6, flagged=True), baseline
    )
    assert ok and verdict["status"] == "spread-flagged"


def test_check_missing_baseline_passes():
    ok, verdict = bench.check_against_baseline(line(), {})
    assert ok and verdict["status"] == "no-baseline"


def test_check_keys_distinguish_configurations():
    ks = {
        key("raft_ticks_per_sec_100k_groups_5_peers"),
        key("raft_ticks_per_sec_100k_groups_5_peers_health"),
        key("raft_ticks_per_sec_100k_groups_5_peers_chaos"),
        key("raft_ticks_per_sec_100k_groups_5_peers", groups=256),
        key("raft_ticks_per_sec_100k_groups_5_peers", device="cpu"),
    }
    assert len(ks) == 5
    assert bench.check_key("m", 256, "cpu") == "m@torch-cpu@g256"
    assert bench.check_key("m", 256, torch.device("cuda", 0)) == "m@torch-cuda@g256"


def test_port_keys_never_meet_the_reference_baseline():
    """No entry of BENCH_baseline.json (the JAX package's `@cpu@`/`@tpu@`
    runs) is a port key, and the port's gate on a metric the file holds
    finds no baseline on either device."""
    base = json.loads((ROOT / "BENCH_baseline.json").read_text(encoding="utf-8"))
    assert base and not any("@torch-" in k for k in base)
    for k in base:
        metric, _backend, g = k.split("@")
        for device in ("cpu", "cuda"):
            ok, verdict = bench.check_against_baseline(
                line(metric=metric, median=1.0, groups=int(g[1:])), base,
                device=device,
            )
            assert ok and verdict["status"] == "no-baseline", verdict


def test_run_check_cli_negative(tmp_path):
    basefile = tmp_path / "base.json"
    basefile.write_text(
        json.dumps({key(): {"median": 1e15, "threshold_pct": 15.0}}),
        encoding="utf-8",
    )
    out = tmp_path / "verdict.json"
    with pytest.raises(SystemExit) as e:
        bench.run_check(args_for(basefile, out), line(median=900e6))
    assert e.value.code == 1
    verdict = json.loads(out.read_text(encoding="utf-8"))
    assert verdict["status"] == "regressed"


def test_run_check_update_baseline_refuses_flagged_run(tmp_path):
    basefile = tmp_path / "base.json"
    with pytest.raises(SystemExit) as e:
        bench.run_check(args_for(basefile, update=True),
                        line(median=900e6, flagged=True))
    assert e.value.code == 1
    assert not basefile.exists()


def test_run_check_update_baseline(tmp_path):
    basefile = tmp_path / "base.json"
    bench.run_check(args_for(basefile, threshold=30.0, update=True, device="cpu"),
                    line(median=900e6))
    saved = json.loads(basefile.read_text(encoding="utf-8"))
    entry = saved[key(device="cpu")]
    assert entry["median"] == 900e6 and entry["threshold_pct"] == 30.0
    # The freshly recorded baseline passes its own check, and gates only
    # its own device.
    bench.run_check(args_for(basefile, device="cpu"), line(median=900e6))
    ok, verdict = bench.check_against_baseline(line(median=1.0), saved)
    assert ok and verdict["status"] == "no-baseline"


def test_check_retired_baseline_skips_with_notice():
    baseline = {
        key(): {
            "median": 1e15, "threshold_pct": 15.0, "retired": True,
            "note": "historical anchor",
        }
    }
    ok, verdict = bench.check_against_baseline(line(median=900e6), baseline)
    assert ok and verdict["status"] == "retired-baseline"
    assert verdict["note"] == "historical anchor"


def test_run_check_update_baseline_refuses_retired(tmp_path):
    basefile = tmp_path / "base.json"
    basefile.write_text(
        json.dumps({key(): {"median": 1.0, "retired": True}}),
        encoding="utf-8",
    )
    with pytest.raises(SystemExit) as e:
        bench.run_check(args_for(basefile, update=True), line(median=900e6))
    assert e.value.code == 1
    saved = json.loads(basefile.read_text(encoding="utf-8"))
    assert saved[key()]["median"] == 1.0  # untouched


def test_fused_fields_units_and_counter():
    bench.fused_fields(0, 0)  # ensure the family + implicit child exist
    child = bench.METRICS.counter("multiraft_fused_rounds_total")._children[()]
    before = child.value
    got = bench.fused_fields(300, 400)
    assert got == {
        "fused_rounds": 300, "total_rounds": 400, "fused_frac": 0.75,
    }
    assert bench.fused_fields(0, 0)["fused_frac"] == 0.0
    assert child.value == before + 300


def test_rep_stats_match_the_reference():
    import bench as ref

    for samples in ([1.0], [3.0, 1.0, 2.0], [10.0, 10.5, 30.0, 9.0, 11.0]):
        assert bench.rep_stats(samples) == ref.rep_stats(samples)


@pytest.mark.parametrize("argv", [
    ["--health-out", "x"], ["--chaos-out", "x"], ["--reconfig-out", "x"],
    ["--reconfig", "a", "--chaos", "b"], ["--check-out", "x"],
    ["--update-baseline"], ["--lossy", "-0.5"], ["--lossy", "1.5"],
    ["--prod-fused", "a", "--chaos", "b"], ["--prod-out", "x"],
    ["--autopilot", "--reconfig", "a"], ["--autopilot-plan", "x"],
    ["--reads", "a", "--autopilot"], ["--reads-out", "x"],
    ["--mesh", "2", "--health"], ["--mesh", "-1"],
    ["--blackbox", "--check-quorum"],
], ids=lambda a: " ".join(a))
def test_flag_checks_match_the_reference(argv, capsys):
    """Every combination bench.py refuses, the port refuses (argparse's exit
    2) before touching a device."""
    with pytest.raises(SystemExit) as e:
        bench.parse_args(argv + ["--device", "cpu"])
    assert e.value.code == 2


def test_mesh_is_not_ported_yet():
    """--mesh is ported (sharding.launch): two CPU ranks print the sharded
    config-5 line."""
    line = bench.main(["--mesh", "2", "--device", "cpu", "--groups", "8", "--reps", "1"])
    assert line["metric"] == "raft_ticks_per_sec_1m_groups_3_peers_sharded"
    assert line["n_devices"] == 2 and line["n_leaders"] == 8 and line["total_commit"] > 0


def test_entry_point_defaults_to_cuda():
    """The bench runs on `cuda` unless told otherwise, and raises rather
    than fall back where there is no card."""
    assert bench.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--groups", "8", "--reps", "1", "--skip-anchor"])
    for fn in (lambda: bench.bench_device(8, 1),
               lambda: bench.bench_blackbox(8, 1)):
        with pytest.raises(RuntimeError):
            fn()


def test_other_new_entry_points_default_to_cuda(tmp_path):
    """The report tools, the forensics smoke and the suites run on `cuda`
    unless told otherwise, and raise rather than fall back where there is
    no card."""
    from raft_tpu_torch.benches import suites
    from raft_tpu_torch.tools import (
        autopilot_report, chaos_churn_report, forensics_smoke, reconfig_report,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    out = str(tmp_path / "out.json")
    calls = (
        lambda: chaos_churn_report.main(["--groups", "8", "--out", out]),
        lambda: reconfig_report.main(["--groups", "8", "--out", out]),
        lambda: autopilot_report.main(["--groups", "8", "--out", out]),
        lambda: forensics_smoke.main(["--out-dir", str(tmp_path)]),
        lambda: suites.main(["--quick"]),
        lambda: suites.baseline_config("config2", 8, 3, "uniform"),
        lambda: bench.bench_chaos(
            str(ROOT / "examples" / "chaos" / "partition_heal.json"), 8, 1),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_command_line_prints_one_line(tmp_path):
    """`python -m raft_tpu_torch.bench --device cpu`: one JSON line on
    stdout, the --health-out summary and a --check verdict written."""
    health = tmp_path / "health.json"
    verdict = tmp_path / "verdict.json"
    res = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.bench", "--device", "cpu",
         "--groups", "16", "--reps", "2", "--skip-anchor", "--health",
         "--health-out", str(health), "--check", str(tmp_path / "base.json"),
         "--check-out", str(verdict), "--fused-floor", "1.0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert res.returncode == 0, res.stderr
    out = res.stdout.strip().splitlines()
    assert len(out) == 1
    doc = json.loads(out[0])
    assert doc["metric"] == "raft_ticks_per_sec_100k_groups_5_peers_health"
    assert doc["fused_frac"] == 1.0 and doc["reps"] == 2 and doc["groups"] == 16
    assert doc["vs_baseline"] is None and doc["anchor"] is None
    assert set(json.loads(health.read_text())) >= {"counts", "worst"}
    assert json.loads(verdict.read_text()) == {
        "key": "raft_ticks_per_sec_100k_groups_5_peers_health@torch-cpu@g16",
        "median": doc["median"], "status": "no-baseline",
    }


def test_fused_floor_exits_one(capsys):
    """--fused-floor above the measured fraction exits 1 after the line is
    printed (the composed path fuses half its blocks at G=16)."""
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--groups", "16", "--reps", "1",
                    "--skip-anchor", "--lossy", "0.01", "--check-quorum",
                    "--fused-floor", "1.0"])
    assert e.value.code == 1
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["fused_frac"] < 1.0


def test_profile_writes_a_trace(tmp_path):
    """--profile DIR brackets the default mode's timed region with a
    torch.profiler trace, written as DIR/trace.json."""
    got = bench.main(["--device", "cpu", "--groups", "16", "--reps", "1",
                      "--skip-anchor", "--profile", str(tmp_path)])
    assert got["fused_frac"] == 1.0
    trace = tmp_path / profiling.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("steady" in str(ev.get("name", "")) or ev.get("ph") == "X"
               for ev in events)


def test_device_trace_and_annotate(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("raft-round"):
            torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any(ev.get("name") == "raft-round" for ev in events)
    profiling.start_trace(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nest"):
        profiling.start_trace(str(tmp_path / "c"))
    assert profiling.stop_trace().endswith(profiling.TRACE_FILE)
    with pytest.raises(RuntimeError):
        profiling.stop_trace()


@pytest.mark.parametrize("samples", [
    [], [0.5], [0.003, 0.001, 0.002], [i / 1000 for i in range(1, 101)],
    [0.25, 0.0001, 0.9, 0.9, 0.013, 0.4, 0.07],
])
def test_round_timer_summary_matches_the_reference(samples):
    from raft_tpu.profiling import RoundTimer as RefTimer

    ours, ref = profiling.RoundTimer(), RefTimer()
    ours.samples, ref.samples = list(samples), list(samples)
    assert ours.summary() == ref.summary()
    with ours.round():
        pass
    assert ours.summary()["count"] == len(samples) + 1
