"""sets.py's figures against values worked out by hand: the spread over
all runs, and the trimmed spread and range with the run farthest from the
median left out, as the check judges a bound."""

import statistics

import pytest

from bench_h100 import sets


def line(value):
    return {"metrics": {"m": {"value": value, "unit": "ms"}}}


def test_trimmed_leaves_out_the_run_farthest_from_the_median():
    assert sets.trimmed([10.0, 11.0, 30.0, 10.5]) == [10.0, 11.0, 10.5]
    assert sets.trimmed([5.0, 10.0, 10.2]) == [10.0, 10.2]


def test_summary_by_hand():
    a = [100.0, 102.0, 101.0, 130.0]
    b = [100.0, 101.0, 100.5, 99.5]
    got = sets.summary([[line(v) for v in a], [line(v) for v in b]])["m"]
    q = statistics.quantiles([100.0, 101.0, 102.0], n=4)
    assert got["sets"][0]["spread_trimmed"] == pytest.approx((q[2] - q[0]) / 101.0)
    assert got["sets"][0]["range_trimmed"] == pytest.approx(2.0 / 101.0)
    assert got["sets"][1]["range_trimmed"] == pytest.approx(1.0 / 100.0)
    assert got["tight_range"] == pytest.approx((2.0 / 101.0 + 1.0 / 100.0) / 2)
    assert got["widest"] == pytest.approx(sets.spread(a))
    assert got["loose"] == pytest.approx(sets.spread(a + b))
    assert got["median_shift"] == pytest.approx(100.25 / 101.5 - 1)
