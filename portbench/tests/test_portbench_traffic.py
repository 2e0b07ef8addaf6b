"""The traffic generator: every seed sends the same lengths, in its own order."""

from collections import Counter

import numpy as np
import pytest
import torch

from portbench import generate

from .conftest import tiny_mix


def _lengths(ladder, cycles):
    return [ladder.request(i).seconds for i in range(cycles * len(ladder.lengths))]


@pytest.mark.parametrize("seeds", [(1, 2), (2 ** 31 + 11, 2 ** 33 + 5), (0, -7)])
def test_ladder_same_multiset_other_order(seeds):
    mix = tiny_mix()
    mix["ladder_s"] = [60, 120, 180, 240, 300, 420, 540, 660, 780, 900, 1080, 1200]
    a, b = (generate.Ladder(mix, s) for s in seeds)
    la, lb = _lengths(a, 5), _lengths(b, 5)
    assert Counter(la) == Counter(lb) == Counter({s: 5 for s in mix["ladder_s"]})
    for c in range(5):  # every cycle sends each rung once
        assert sorted(la[12 * c: 12 * c + 12]) == sorted(mix["ladder_s"])
    assert la != lb


def test_same_seed_same_requests_and_offsets():
    mix = tiny_mix()
    a, b = generate.Ladder(mix, 99), generate.Ladder(mix, 99)
    assert _lengths(a, 4) == _lengths(b, 4)
    for s in range(mix["distinct_sets"]):
        for rung, length in enumerate(mix["ladder_s"]):
            start = a.offset(s, rung, mix["master_s"])
            assert start == b.offset(s, rung, mix["master_s"])
            assert 0 <= start <= mix["master_s"] - length
    assert [a.request(i).set for i in range(9)] == [0, 0, 0, 1, 1, 1, 0, 0, 0]


def test_master_is_seeded_and_bounded():
    mix = tiny_mix()
    m1 = generate.master(mix, 5, torch.device("cpu"))
    m2 = generate.master(mix, 5, torch.device("cpu"))
    m3 = generate.master(mix, 6, torch.device("cpu"))
    assert m1.shape == (2, mix["master_s"] * mix["src_rate"]) and m1.dtype == torch.float32
    assert torch.equal(m1, m2) and not torch.equal(m1, m3)
    assert float(m1.abs().max()) == pytest.approx(mix["peak"])


@pytest.mark.parametrize("seconds,windows", [(60, 14), (1200, 267), (5, 1), (0.1, 1)])
def test_windows_for(seconds, windows):
    assert generate.windows_for(seconds, 16000, 5.0, 0.5) == windows


def test_seed_ints_take_large_and_negative_seeds():
    vals = generate.seed_ints(2 ** 40 + 3, 3) + generate.seed_ints(-5, 2)
    assert all(0 <= v < 2 ** 63 for v in vals)
    assert len(set(vals)) == 5
    np.random.default_rng(vals[0])
    torch.Generator().manual_seed(vals[0])
