"""The frozen bounds of the fused kernels."""

import pytest

from portbench import bounds


@pytest.mark.parametrize("P", [3, 5])
def test_steady_work(P):
    G, k = 1_000_000, 32
    nbytes, ops = bounds.steady_work(G, P, k)
    assert nbytes == (8 * 4 + 3 + 6 * 4) * P * G + 8 * G
    assert ops == 5 * P * k * G
    # the floor stays under the steady kernel's own source count (15P + 14)
    assert 5 * P < 15 * P + 14


@pytest.mark.parametrize("P", [3, 5])
def test_damped_work(P):
    G, k = 1_000_000, 8
    nbytes, ops = bounds.damped_work(G, P, k)
    assert nbytes == (8 * 4 + 4) * P * G + 4 * P * P * G + 12 * G + (8 * 4 + 1) * P * G + 4 * P * P * G
    assert ops == (6 * P - 1) * k * G


def test_bounds_at_the_cells():
    t, which = bounds.bound("steady", 1_000_000, 3, 32)
    assert which == "bytes" and abs(t - 185e6 / 3.35e12) < 1e-9
    t, which = bounds.bound("damped", 1_000_000, 3, 8)
    assert which == "bytes" and abs(t - 291e6 / 3.35e12) < 1e-9
    # P = 5 at 100k, k = 32: operations bound the steady call
    assert bounds.bound("steady", 100_000, 5, 32)[1] == "bytes"
    assert bounds.bound("steady", 100_000, 5, 256)[1] == "operations"


def test_roofline_share_is_at_most_100_when_time_is_at_least_the_bound():
    from types import SimpleNamespace

    from portbench.stats import BlockRecord
    from portbench.trace import Op, TraceView

    t, _ = bounds.bound("steady", 1000, 3, 32)
    ops = [Op("void steady_round_kernel<3, false>", 0.0, t * 1e6, 0.0), Op("add", 0.0, 5.0, 0.0)]
    view = TraceView([ops], ops, [], 0.0, 1.0, 0.0)
    ctx = SimpleNamespace(trace=view, fused_kernel="steady_round_kernel", G=1000, P=3, k=32,
                          traced=[BlockRecord(0, 0.0, 1.0, True, 32, True)])
    assert abs(bounds.roofline_share(ctx, "steady") - 100.0) < 1e-6
    assert bounds.roofline_share(ctx, "damped") is None
