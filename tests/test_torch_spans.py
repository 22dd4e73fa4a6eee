"""The port's spans (`raft_tpu_torch.profiling.annotate`, `phased` and
`phases`) on the CPU at a small fleet: under `torch.profiler` a fused block
and a general block of `fused_step.fast_multi_round` emit the dispatcher's
`dispatch.*`, the fused wrapper's `fused.*` and the general round's
`general.*` ranges, nested in order, for a plain and a damped config; with
no profiler both helpers return the one shared no-op; a phase open when
its call raises is closed then; the states out are bit-identical with the
profiler on and off; `chip_smoke.py`'s device profile leaves the spans'
own rows out; and `tools/span_split.py` splits a trace by span."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from raft_tpu_torch import profiling
from raft_tpu_torch.multiraft import fused_step, sim
from raft_tpu_torch.tools import span_split

G, P, K = 16, 3, 4
CONFIGS = {
    "plain": dict(election_tick=10, heartbeat_tick=1),
    "damped": dict(election_tick=10, heartbeat_tick=2, check_quorum=True,
                   pre_vote=True),
}
PHASES = {
    "plain": ["general.tick", "general.campaign", "general.elect",
              "general.replicate"],
    "damped": ["general.tick", "general.campaign", "general.wave1",
               "general.wave2", "general.elect", "general.wave3",
               "general.wave4", "general.wave5", "general.wave6",
               "general.workload"],
}
FUSED = ["dispatch.predicate", "dispatch.wait", "fused.operands",
         "fused.kernel", "fused.merge"]


def _fleet(name):
    """(cfg, initial state, settled state, crashed, append): the settled
    state is the first one, 8 rounds apart, whose k-round predicate holds."""
    cfg = sim.SimConfig(n_groups=G, n_peers=P, **CONFIGS[name])
    crashed = torch.zeros((P, G), dtype=torch.bool)
    append = (torch.arange(G, dtype=torch.int32) % 3 == 0).to(torch.int32)
    init = sim.init_state(cfg, device="cpu")
    st = init
    for _ in range(64):
        for _ in range(8):
            st = sim.step(cfg, st, crashed, append)
        if bool(fused_step.steady_predicate(cfg, st, crashed, horizon=K)):
            return cfg, init, st, crashed, append
    raise AssertionError("the fleet did not settle")


def _spans(tmp_path, fn):
    """The user_annotation ranges (name, start us, end us) that `fn()`
    emits under the profiler, in start order, and fn's result."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(
        (e["ts"], -e.get("dur", 0.0), e["name"]) for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
    )
    return [(n, ts, ts - d) for ts, d, n in spans], out


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _in_sequence(spans):
    """Each range ends before the next one starts."""
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_blocks_emit_the_layers_spans_in_order(tmp_path, name):
    cfg, init, settled, crashed, append = _fleet(name)
    block = fused_step.fast_multi_round(cfg, K, count_fused=True)

    spans, (_, fused) = _spans(tmp_path, lambda: block(settled, crashed, append, 0))
    assert fused == K * G
    assert [s[0] for s in spans] == FUSED
    assert _in_sequence(spans)

    spans, (_, fused) = _spans(tmp_path, lambda: block(init, crashed, append, 0))
    assert fused == 0
    top = [s for s in spans if s[0].startswith("dispatch.") or s[0] == "general.round"]
    assert [s[0] for s in top] == ["dispatch.predicate", "dispatch.wait"] + ["general.round"] * K
    assert _in_sequence(top)
    for rnd in top[2:]:
        inner = [s for s in spans if _inside(s, rnd) and s is not rnd]
        phases = [s for s in inner if s[0] not in ("general.draw", "general.extras")]
        assert [s[0] for s in phases] == PHASES[name]
        assert [s[0] for s in inner if s[0] == "general.extras"] == ["general.extras"]
        assert _in_sequence(phases + [s for s in inner if s[0] == "general.extras"])
        assert _in_sequence(phases)
        draws = [s for s in inner if s[0] == "general.draw"]
        assert draws and all(any(_inside(d, p) for p in phases) for d in draws)
    assert not any(s[0].startswith("fused.") for s in spans)


def test_without_a_profiler_the_helpers_are_the_shared_no_op():
    seen = []

    @profiling.phased
    def body():
        ph = profiling.phases()
        ph("general.tick")
        seen.append(ph)

    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("dispatch.wait") is profiling.QUIET
    assert profiling.phases() is profiling.QUIET
    with profiling.annotate("x") as ctx:
        body()
    assert ctx is profiling.QUIET and seen == [profiling.QUIET]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.annotate("x") is not profiling.QUIET
        body()
    assert seen[1] is not profiling.QUIET


def test_a_phase_open_when_its_call_raises_is_closed_then(tmp_path):
    @profiling.phased
    def body():
        ph = profiling.phases()
        ph("general.tick")
        ph("general.campaign")
        raise ValueError("refused")

    def run():
        try:
            body()
        except ValueError:
            with profiling.annotate("after"):
                pass
        return None

    spans, _ = _spans(tmp_path, run)
    assert [s[0] for s in spans] == ["general.tick", "general.campaign", "after"]
    assert _in_sequence(spans)
    assert not profiling._calls.stack


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_states_are_bit_identical_with_the_profiler_on_and_off(tmp_path, name):
    cfg, init, settled, crashed, append = _fleet(name)
    block = fused_step.fast_multi_round(cfg, K, count_fused=True)
    for st in (settled, init):
        off = block(st, crashed, append, 0)
        _, on = _spans(tmp_path, lambda: block(st, crashed, append, 0))
        assert off[1] == on[1]
        for field, a, b in zip(sim.SimState._fields, off[0], on[0]):
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), field


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_profile_mutes_the_spans(monkeypatch):
    """chip_smoke's device profile reads the host's own pace: a fused and a
    general block profiled through it open no span, and the spans come back
    after it."""
    cs = _chip_smoke()
    cfg, init, settled, crashed, append = _fleet("damped")
    block = fused_step.fast_multi_round(cfg, K, count_fused=True)
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    prof = cs.device_profile(lambda: (block(settled, crashed, append, 0),
                                      block(init, crashed, append, 0)))
    assert opened == [] and prof["wall_us"] > 0
    assert not set(FUSED) & {k["name"] for k in prof["kernels"]}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        block(settled, crashed, append, 0)
    assert opened == FUSED


def test_device_profile_leaves_the_spans_rows_out(tmp_path):
    """With CUDA activity on, the profiler gives each span that encloses
    device work a CUDA row of its own (a user annotation) over the same
    kernels; chip_smoke's device profile keeps only the kernels."""
    from torch.autograd import DeviceType

    cs = _chip_smoke()
    cfg, init, settled, crashed, append = _fleet("damped")
    block = fused_step.fast_multi_round(cfg, K, count_fused=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        block(settled, crashed, append, 0)
        block(init, crashed, append, 0)
    names = {e.key for e in prof.key_averages() if e.is_user_annotation}
    assert set(FUSED) | set(PHASES["damped"]) <= names

    def row(key, annotation):
        return SimpleNamespace(key=key, device_type=DeviceType.CUDA, count=2,
                               self_device_time_total=5.0, is_user_annotation=annotation)

    on_card = [row("damped_rounds_kernel", False), row("memcpy DtoH", False)]
    on_card += [row(n, True) for n in sorted(names)]
    on_card += list(prof.key_averages())  # the host's rows
    kept = [e.key for e in cs.device_rows(on_card)]
    assert kept == ["damped_rounds_kernel", "memcpy DtoH"]
    assert not names & set(kept)


def _op(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _span(name, ts, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts}


def test_span_split_reads_a_hand_built_trace(tmp_path):
    """A fused block, a host gap and a general block: each idle part goes to
    the innermost span open over it, each operation to the span open at its
    launch, and every label's parts sum to the label."""
    events = [
        _span("block", 0, 100), _span("sync", 100, 110),
        _span("dispatch.predicate", 1, 20), _span("dispatch.wait", 20, 30),
        _span("fused.operands", 30, 40), _span("fused.kernel", 40, 50),
        _span("fused.merge", 50, 90),
        _op("cuda_runtime", "cudaLaunchKernel", 5, 1, 1), _op("kernel", "steady_predicate_kernel", 10, 15, 1),
        _op("cuda_runtime", "cudaLaunchKernel", 45, 1, 2), _op("kernel", "steady", 60, 20, 2),
        _op("cuda_runtime", "cudaMemcpyAsync", 96, 1, 3), _op("gpu_memcpy", "DtoH", 95, 3, 3),
        _op("cuda_runtime", "cudaLaunchKernel", 198, 1, 4), _op("kernel", "fill", 199, 1, 4),
        _span("block", 200, 300), _span("sync", 300, 305),
        _span("general.round", 205, 295), _span("general.tick", 206, 250),
        _span("general.draw", 210, 220),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = span_split.split(json.loads(path.read_text())["traceEvents"])
    assert out["window_s"] == pytest.approx(305e-6)
    assert out["blocks"] == {"block.fused": {"n": 1, "ms": 0.1, "rounds": 0},
                             "block.general": {"n": 1, "ms": 0.1, "rounds": 1}}
    us = {k: round(v * 1e6, 6) for k, v in out["idle_refined_s"].items()}
    assert us == {
        "block.fused": 6.0, "block.fused/dispatch.predicate": 9.0,
        "block.fused/dispatch.wait": 5.0, "block.fused/fused.operands": 10.0,
        "block.fused/fused.kernel": 10.0, "block.fused/fused.merge": 20.0,
        "host": 101.0, "block.general": 15.0, "block.general/general.round": 46.0,
        "block.general/general.tick": 34.0, "block.general/general.draw": 10.0,
    }
    assert {k: round(v * 1e6, 6) for k, v in out["idle_by_label_s"].items()} == {
        "block.fused": 60.0, "host": 101.0, "block.general": 105.0}
    assert out["refined_sum_max_abs_diff_s"] < 1e-12
    dev = {k: (round(v["device_ms"] * 1e3, 6), v["launches"])
           for k, v in out["by_span"].items() if v["launches"]}
    assert dev == {"block.fused/dispatch.predicate": (15.0, 1),
                   "block.fused/fused.kernel": (20.0, 1), "block.fused/-": (3.0, 1),
                   "host/-": (1.0, 1)}
    assert out["gap_end_skew_us"] == {"min": -1.0, "median": 3.0, "negative": 1, "n": 4}
    assert out["predicate"] == {
        "fused_blocks": 1, "kernel_records_min": 1, "kernel_records_max": 1,
        "launches_min": 1, "launches_max": 1, "device_ms_mean": 0.015}
    assert span_split.main([str(path), "--out", str(tmp_path / "split.json")]) == 0
    assert json.loads((tmp_path / "split.json").read_text()) == out


def test_span_split_on_a_profiled_block(tmp_path):
    """On a CPU trace of a general block (no device operations, so every
    microsecond is idle), the split's parts sum to the window and the
    phases hold the time."""
    cfg, init, settled, crashed, append = _fleet("plain")
    block = fused_step.fast_multi_round(cfg, K, count_fused=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        block(init, crashed, append, 0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = span_split.split(json.loads(path.read_text())["traceEvents"])
    parts = out["idle_refined_s"]
    assert sum(parts.values()) == pytest.approx(out["window_s"], abs=1e-9)
    assert {f"host/{p}" for p in PHASES["plain"]} <= set(parts)
    assert out["device_ops"] == 0 and out["gap_end_skew_us"]["n"] == 0
