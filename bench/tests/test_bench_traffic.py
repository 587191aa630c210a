"""The generator: the same seed gives the same inputs; a seed permutes
one fixed set of arrival gaps; percentiles are over every sample."""
import numpy as np
import pytest
import torch

from harness import stats
from harness.traffic import observation, poisson_arrivals, stream_seed

CFG = {"vocab_size": 1000,
       "vision": {"num_patches": 8, "patch_embed_dim": 16}}
BIG = 2 ** 33 + 12345


def test_observations_repeat_by_seed_and_differ_by_seed_and_index():
    a = observation(CFG, 2, 5, BIG, 3, "cpu")
    b = observation(CFG, 2, 5, BIG, 3, "cpu")
    c = observation(CFG, 2, 5, BIG + 1, 3, "cpu")
    d = observation(CFG, 2, 5, BIG, 4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[1], d[1])
    assert a[0].dtype == torch.long and a[1].dtype == torch.bfloat16
    assert int(a[0].max()) < 1000 and tuple(a[1].shape) == (2, 8, 16)


def test_arrivals_are_one_poisson_draw_for_every_run():
    a = poisson_arrivals(7.0, 400, 11)
    b = poisson_arrivals(7.0, 400, 11)
    c = poisson_arrivals(7.0, 400, 12)
    np.testing.assert_array_equal(a, b)
    assert a[0] > 0.0 and np.all(np.diff(a) >= 0)
    assert not np.array_equal(a, c)
    assert 6.0 < 400 / a[-1] < 8.0
    # the frozen copy of the program's fleet_trace arrivals: one
    # exponential gap a draw from one default_rng
    rng = np.random.default_rng(11)
    t, want = 0.0, []
    for _ in range(400):
        t += float(rng.exponential(1.0 / 7.0))
        want.append(t)
    np.testing.assert_allclose(a, want)


def test_stream_seeds_take_large_seeds_and_separate_streams():
    s = {stream_seed(BIG, "obs", 0), stream_seed(BIG, "obs", 1),
         stream_seed(BIG, "weights"), stream_seed(2 ** 31 + 5, "weights")}
    assert len(s) == 4 and all(0 <= x < 2 ** 63 for x in s)


def test_percentile_is_over_all_samples():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile(vals[::-1], 50) == pytest.approx(50.5)
    # a tail over all requests is not a median of the pieces' tails
    slow = [1.0] * 95 + [100.0] * 5
    tails = [stats.percentile(slow[i:i + 10], 95) for i in range(0, 100, 10)]
    assert stats.median(tails) == 1.0
    assert stats.percentile(slow, 95) == pytest.approx(1.0 + 0.05 * 99)
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)
