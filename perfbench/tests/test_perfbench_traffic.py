"""The traffic generator: deterministic for a seed, the same sizes for
every seed, the stated distributions."""

import statistics

import numpy as np
import pytest

from perfbench import traffic

SEARCH = traffic.load_mix("search")
REINDEX = traffic.load_mix("reindex")


def test_perfbench_lengths_deterministic_for_a_seed():
    a = traffic.lengths(SEARCH["source_bytes"], 4096, 2 ** 40 + 3)
    b = traffic.lengths(SEARCH["source_bytes"], 4096, 2 ** 40 + 3)
    c = traffic.lengths(SEARCH["source_bytes"], 4096, 2 ** 40 + 4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))  # same sizes, another order


def test_perfbench_search_sources_follow_the_mix():
    a = traffic.lengths(SEARCH["source_bytes"], 4096, 11)
    assert a.min() >= 512 and a.max() <= 2300
    long = (a >= 1800).mean()
    assert long == pytest.approx(0.8, abs=1e-3)
    short = a[a < 1800]
    assert short.mean() == pytest.approx((512 + 1799) / 2, rel=0.01)


def test_perfbench_premises_follow_the_lognormal():
    spec = REINDEX["premise_bytes"]["lognormal"]
    a = traffic.lengths(REINDEX["premise_bytes"], 130_000, 5)
    assert a.min() >= spec["min"] and a.max() <= spec["max"]
    assert np.median(a) == pytest.approx(spec["median"], rel=0.01)
    # one sigma above the median, and the shares the clips take
    assert np.percentile(np.log(a), 84.13) - np.log(np.median(a)) == pytest.approx(
        spec["sigma"], rel=0.03)
    dist = statistics.NormalDist(np.log(spec["median"]), spec["sigma"])
    assert (a == spec["max"]).mean() == pytest.approx(1 - dist.cdf(np.log(spec["max"])), abs=1e-3)
    assert (a == spec["min"]).mean() == pytest.approx(dist.cdf(np.log(spec["min"])), abs=1e-3)


def test_perfbench_texts_lengths_and_bytes():
    n = np.array([0, 1, 17, 300])
    t1 = traffic.texts(n, 2 ** 33 + 1, stream=5)
    t2 = traffic.texts(n, 2 ** 33 + 1, stream=5)
    assert t1 == t2
    assert [len(t.encode()) for t in t1] == n.tolist()
    assert all(all(32 <= ord(c) < 127 or c == "\n" for c in t) for t in t1)
    assert traffic.texts(n, 2 ** 33 + 1, stream=6) != t1
