"""The metric arithmetic on synthetic records."""

import torch

from portbench import stats


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 100], 95) == 100


def test_weighted_percentile_matches_repeats():
    vals, w = [5.0, 1.0, 3.0], [2, 97, 1]
    flat = [v for v, n in zip(vals, w) for _ in range(n)]
    assert stats.weighted_percentile(vals, w, 95) == stats.percentile(flat, 95)
    assert stats.weighted_percentile(vals, w, 99) == stats.percentile(flat, 99)


def _state(P, G, leader_at, commit, ts, term=1):
    st = torch.zeros((P, G), dtype=torch.int32)
    for g, p in enumerate(leader_at):
        if p is not None:
            st[p, g] = 2
    z = torch.zeros((P, G), dtype=torch.int32)
    return type("S", (), dict(state=st, term=z + term, commit=z + commit,
                              term_start_index=z + ts))


def test_recovered_needs_a_committed_entry_of_its_own_term():
    P, G = 3, 4
    s = _state(P, G, [0, 1, None, 2], commit=5, ts=5)
    crashed = torch.zeros((P, G), dtype=torch.bool)
    crashed[2, 3] = True  # group 3's leader is down
    assert stats.recovered(s, crashed).tolist() == [True, True, False, False]
    s2 = _state(P, G, [0, 1, None, 2], commit=4, ts=5)  # noop not committed
    assert not stats.recovered(s2, crashed).any()


def test_incident_samples_count_stalls_at_window_end():
    lost = torch.tensor([True, True, True, False])
    inc = stats.Incident(t_issue=10.0, first_block=2, lost=lost)
    ends = [0, 0, 10.5, 11.0, 11.5]
    P, G = 3, 4
    crashed = torch.zeros((P, G), dtype=torch.bool)
    inc.update(2, _state(P, G, [0, None, None, None], 1, 1), crashed)
    inc.update(3, _state(P, G, [0, 1, None, None], 1, 1), crashed)
    assert inc.open
    got = sorted(inc.samples(ends, window_end=12.0))
    assert got == [(0.5, 1), (1.0, 1), (2.0, 1)]
