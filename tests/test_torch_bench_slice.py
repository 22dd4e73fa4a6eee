"""The port's bench against the repository's `bench.py` on the modes of
bench_device: default, --health (with --health-out), --lossy,
--check-quorum and --check-quorum --health, and --blackbox, which runs
bench_device too, each at G = 32, one rep, on the CPU (the
reference's Pallas kernels in interpret mode, as bench.py runs them there;
the port's fused wrappers on their plain versions).  The two lines must be
equal on every field not derived from time: the metric key, the flags,
fused_rounds, total_rounds and fused_frac.  The default mode also runs the
port's native anchor (built at -O3 into build/).  --lossy --check-quorum
is in test_torch_bench_scenarios_slice.py."""

import json
import sys

import pytest

from raft_tpu_torch import bench as port

G = 32
# Fields derived from the clock: the rep statistics, the headline value,
# the anchor and the ratios built from them.
TIMED = {
    "value", "min", "median", "max", "spread_pct", "spread_flagged",
    "vs_baseline", "anchor", "blackbox_overhead_pct",
    "blackbox_overhead_fused_pct",
}


def untimed(x):
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMED}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def reference_line(argv, capsys, monkeypatch):
    """bench.py's main on `argv` (the anchor skipped: it builds into cpp/);
    its last stdout line."""
    import bench as ref

    monkeypatch.setattr(sys, "argv", ["bench.py", "--groups", str(G),
                                      "--reps", "1", "--skip-anchor", *argv])
    capsys.readouterr()
    ref.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def port_line(argv, capsys, anchor=False):
    """The port's main on `argv` with --device cpu; what it prints must be
    what it returns."""
    capsys.readouterr()
    got = port.main(["--device", "cpu", "--groups", str(G), "--reps", "1",
                     *([] if anchor else ["--skip-anchor"]), *argv])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    return got


def assert_same_line(ours, ref):
    assert untimed(ours) == untimed(ref)
    assert set(ours) == set(ref)


def test_default_with_anchor(capsys, monkeypatch):
    ref = reference_line([], capsys, monkeypatch)
    ours = port_line([], capsys, anchor=True)
    assert_same_line(ours, ref)
    assert ours["fused_frac"] == 1.0
    assert ours["anchor"]["reps"] == 1 and ours["anchor"]["median"] > 0
    assert ours["vs_baseline"] == round(ours["median"] / ours["anchor"]["median"], 2)


def test_health_and_its_summary(capsys, monkeypatch, tmp_path):
    ref = reference_line(["--health", "--health-out", str(tmp_path / "r.json")],
                         capsys, monkeypatch)
    ours = port_line(["--health", "--health-out", str(tmp_path / "p.json")], capsys)
    assert_same_line(ours, ref)
    assert ours["health"] is True and ours["fused_frac"] == 1.0
    assert (json.loads((tmp_path / "p.json").read_text())
            == json.loads((tmp_path / "r.json").read_text()))


@pytest.mark.parametrize("argv", [
    ["--lossy", "0.01"],
    ["--check-quorum"],
    ["--check-quorum", "--health"],
], ids=lambda a: " ".join(a))
def test_lossy_and_damped(argv, capsys, monkeypatch):
    ref = reference_line(argv, capsys, monkeypatch)
    ours = port_line(argv, capsys)
    assert_same_line(ours, ref)
    assert ours["fused_frac"] == 1.0


def test_blackbox(capsys, monkeypatch):
    ref = reference_line(["--blackbox"], capsys, monkeypatch)
    ours = port_line(["--blackbox"], capsys)
    assert_same_line(ours, ref)
    for tag in ("general_off", "general_on", "fused_off"):
        assert set(ours[tag]) == set(ref[tag])
    assert ours["fused_off"]["fused_frac"] == 1.0
