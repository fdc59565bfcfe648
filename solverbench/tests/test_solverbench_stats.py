import statistics

import numpy as np
import pytest

from solverbench import stats


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(110, 35.0) == pytest.approx(110 / 35.0)
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 110, 1001])
def test_percentile_matches_numpy_linear(q, n):
    v = list(np.random.default_rng(n).exponential(size=n))
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q),
                                                   rel=1e-12)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_spread_uses_statistics_quartiles():
    v = [10.0, 10.4, 9.8, 10.1, 10.9, 9.9]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)
    assert stats.spread([5.0] * 6) == 0.0
