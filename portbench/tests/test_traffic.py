"""The traffic generator: seeded, YCSB's scrambled Zipfian, the store
placement and the fault schedules."""

import numpy as np
import pytest
import torch

from portbench import generator, spec

SEED = 2**31 + 12345


def make(name, seed=SEED, G=3000, P=3, k=8):
    return generator.Traffic(spec.traffic(name), G, P, k, seed, "cpu")


def ycsb():
    return spec.module(spec.PACKAGE, "appends", "ycsb_zipfian")


@pytest.mark.parametrize("name", ["ycsb", "store-loss", "storm"])
def test_same_seed_same_inputs(name):
    a, b = make(name), make(name)
    assert torch.equal(a.tables, b.tables)
    for r in range(0, 1024, 8):
        x, y = a.block(r), b.block(r)
        assert torch.equal(x.crashed, y.crashed) and torch.equal(x.append, y.append)
        assert (x.reset is None) == (y.reset is None)
        assert (x.incident, x.table) == (y.incident, y.table)


@pytest.mark.parametrize("name", ["ycsb", "store-loss"])
def test_seeds_differ(name):
    a, b = make(name), make(name, seed=SEED + 1)
    assert not torch.equal(a.tables, b.tables)
    if name == "store-loss":
        assert ([a.faults.store(i) for i in range(32)]
                != [b.faults.store(i) for i in range(32)])


def test_zeta_and_the_rank_distribution_are_ycsbs():
    y = ycsb()
    # YCSB's ScrambledZipfianGenerator.ZETAN for 10^10 items at theta 0.99.
    assert y.zeta(10_000_000_000, 0.99) == pytest.approx(26.46902820178302, rel=1e-11)
    n = 3_000_000
    assert y.zeta(n, 0.99, exact=1000) == pytest.approx(
        float(np.sum(np.arange(1, n + 1, dtype=np.float64) ** -0.99)), rel=1e-12)
    # Gray et al.'s generator: ranks 0 and 1 exactly as Zipf's, the rest
    # by its closed form, P(rank < r) = ((r / n)^(1 - theta) - 1) / eta + 1,
    # which lies within a few hundredths of Zipf's own.
    items, theta, draws = 1000, 0.99, 2_000_000
    ranks = y.zipfian_ranks(np.random.default_rng(5).random(draws), items, theta)
    assert ranks.min() == 0 and ranks.max() < items
    got = np.bincount(ranks, minlength=items) / draws
    zetan = y.zeta(items, theta)
    pmf = np.arange(1, items + 1, dtype=np.float64) ** -theta / zetan
    for r in (0, 1):
        assert got[r] == pytest.approx(pmf[r], abs=5 * np.sqrt(pmf[r] / draws))
    eta = (1 - (2 / items) ** (1 - theta)) / (1 - y.zeta(2, theta) / zetan)
    for r in (10, 100, 500):
        cdf = ((r / items) ** (1 - theta) - 1) / eta + 1
        assert got[:r].sum() == pytest.approx(cdf, abs=5 * np.sqrt(cdf * (1 - cdf) / draws))
        assert abs(cdf - pmf[:r].sum()) < 0.02


def test_fnv_hash_is_ycsbs():
    # FNV-1a-64 of the eight bytes of 0, then YCSB's Math.abs.
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = (h * 1099511628211) % 2**64
    want = abs(h - 2**64 if h >= 2**63 else h)
    assert int(ycsb().fnvhash64(np.array([0]))[0]) == want


def test_ycsb_rows_count_every_update_once():
    t = make("ycsb", G=20000)
    p = spec.traffic("ycsb")["appends"]
    assert t.tables.dtype == torch.int32
    assert t.tables.shape == (p["rows"], 20000)
    assert torch.all(t.tables.sum(1) == round(p["updates_per_group_round"] * 20000))
    # the hottest key's group is the hottest over all rows, and most groups idle
    total = t.tables.sum(0)
    assert int(total.max()) > 10 * float(total.float().mean())
    assert float((t.tables == 0).float().mean()) > 0.98


def test_blocks_take_the_rows_in_turn():
    t = make("ycsb", k=32)
    rows = t.tables.shape[0]
    assert [t.block(32 * i).table for i in range(rows + 2)] == list(range(rows)) + [0, 1]


def test_store_placement_hits_a_tenth_of_groups():
    m = spec.module(spec.PACKAGE, "faults", "store_loss").store_masks(30, 3, 3000, "cpu")
    assert m.shape == (30, 3, 3000)
    hit = m.any(1).sum(1)
    assert torch.all(hit == 300)
    # every replica lives on exactly one store, and a store holds at most
    # one replica of a group
    assert torch.all(m.sum(0) == 1) and torch.all(m.sum(1) <= 1)


def test_store_loss_schedule():
    t = make("store-loss")
    assert not t.resets
    for r in range(0, 1024, 8):
        b = t.block(r)
        pos = r % 128
        assert b.incident == (pos == 0) and b.reset is None
        assert bool(b.crashed.any()) == (pos < 32)
        if pos < 32:
            assert torch.equal(b.crashed, t.faults.masks[t.faults.store(r // 128)])


def test_storm_schedule():
    t = make("storm", k=32)
    assert t.resets
    for r in range(0, 1024, 32):
        b = t.block(r)
        assert b.incident == (r % 256 == 0) == (b.reset is not None)
        assert b.reset is None or bool(b.reset.all())
        assert not b.crashed.any()


def test_block_must_divide_the_periods():
    with pytest.raises(ValueError):
        make("store-loss", k=48)
