"""The trace reader: operations go to the block whose host call launched
them, whatever the device clock's skew; busy and idle time; breakdown."""

from portbench import trace


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribution_by_correlation_and_idle():
    ev = [
        X("user_annotation", "block", 0, 10), X("user_annotation", "sync", 10, 90),
        X("user_annotation", "block", 100, 10), X("user_annotation", "sync", 110, 90),
        X("cuda_runtime", "cudaLaunchKernel", 2, 1, 1),
        X("cuda_runtime", "cudaLaunchKernel", 5, 1, 2),
        X("cuda_runtime", "cudaLaunchKernel", 102, 1, 3),
        # the device clock runs late: block 0's second kernel starts after
        # block 1's span opened, yet belongs to block 0
        X("kernel", "steady_round_kernel<3>", 50, 40, 1),
        X("kernel", "add", 101, 4, 2),
        X("kernel", "steady_round_kernel<3>", 150, 30, 3),
    ]
    v = trace.read_events(ev, ["block.fused", "block.general"])
    assert [[o.name for o in b] for b in v.blocks] == [
        ["steady_round_kernel<3>", "add"], ["steady_round_kernel<3>"]]
    assert v.window_s == 200e-6 and abs(v.busy_s - 74e-6) < 1e-12
    bd = trace.breakdown(v)
    assert bd["device_ops"][0][0] == "steady_round_kernel<3>"
    assert abs(sum(s for _, s in bd["idle_gaps"]) - 126e-6) < 1e-12
    assert {n for n, _ in bd["idle_gaps"]} <= {"block.fused", "block.general", "sync", "host"}
