"""The spread that bounds are set from: the distance between the first and
third quartiles of ``statistics.quantiles(values, n=4)`` over the median,
and the same with the run farthest from the median left out."""

import statistics
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from velobench import spread  # noqa: E402


def test_spread_is_the_quartiles_over_the_median():
    vals = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert spread.spread(vals) == pytest.approx((q3 - q1) / med)
    # the exclusive quartiles of six runs lie wider than numpy's
    assert spread.spread(vals) > (101.0 - 99.25) / 100.25


def test_one_far_run_is_left_out_of_the_trimmed_spread():
    vals = [100.0, 100.2, 99.8, 100.1, 99.9, 130.0]
    assert spread.spread_trimmed(vals) == pytest.approx(spread.spread(vals[:5]))
    assert spread.spread_trimmed(vals) < spread.spread(vals) / 10


def test_summary_bounds_five_times_the_widest_spread_never_under_one_percent():
    line = lambda q, r: {"metrics": {"qps.x": {"value": q}, "recall_at_10.x": {"value": r}}}  # noqa: E731
    a = [line(100 + i, 0.5) for i in range(6)]
    b = [line(100 + 2 * i, 0.5) for i in range(6)]
    s = spread.summary([a, b])
    assert s["qps.x"]["spreads"][1] > s["qps.x"]["spreads"][0]
    assert s["qps.x"]["bound"] == pytest.approx(5 * s["qps.x"]["spreads"][1])
    assert s["recall_at_10.x"]["bound"] == 0.01
