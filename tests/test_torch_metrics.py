"""Edge cases of the port's serving metrics bag
(``repro_torch.serve.metrics``), the cases of tests/test_metrics.py, and
the port's copy against the reference's on the same samples.

The fleet controller makes *decisions* off these numbers (placement
views, the hang watchdog reads counters, BENCH reports quote the
quantiles), so the edges have to be exact: empty and single-sample
windows, ring eviction at the window boundary vs exact lifetime
aggregates, and counter monotonicity.
"""
import numpy as np

import pytest

from repro.serve import Metrics as RefMetrics
from repro_torch.serve import Metrics
from repro_torch.serve.metrics import _Series


def test_empty_series_summary_is_zeroed():
    """A series with no samples reports zeros everywhere — not NaN, not
    a crash (np.percentile of an empty array would give NaN)."""
    s = _Series(window=8).summary()
    assert s == {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                 "p50": 0.0, "p90": 0.0, "p99": 0.0}


def test_single_sample_window():
    """One sample: every quantile IS the sample, aggregates agree."""
    m = Metrics(window=8)
    m.observe("lat", 42.5)
    s = m.snapshot()["series"]["lat"]
    assert s["count"] == 1
    assert s["mean"] == s["min"] == s["max"] == 42.5
    assert s["p50"] == s["p90"] == s["p99"] == 42.5


def test_window_wrap_evicts_quantiles_keeps_lifetime_exact():
    """Past the window the quantile ring holds only the newest samples,
    while count/mean/min/max stay exact over the full lifetime."""
    m = Metrics(window=4)
    for v in range(1, 11):                    # 1..10 into a 4-ring
        m.observe("q", float(v))
    s = m.snapshot()["series"]["q"]
    assert s["count"] == 10                   # lifetime, not window
    assert s["min"] == 1.0 and s["max"] == 10.0
    assert s["mean"] == 5.5
    assert s["p50"] == np.percentile([7.0, 8.0, 9.0, 10.0], 50)
    assert s["p99"] <= 10.0


def test_window_not_yet_full_uses_all_samples():
    m = Metrics(window=100)
    for v in (1.0, 2.0, 3.0):
        m.observe("q", v)
    assert m.snapshot()["series"]["q"]["p50"] == 2.0


def test_counters_monotone_and_default_zero():
    m = Metrics()
    assert m.counter("frames") == 0           # never incremented
    m.inc("frames")
    m.inc("frames", 2.5)
    assert m.counter("frames") == 3.5
    snap = m.snapshot()["counters"]
    assert snap == {"frames": 3.5}
    assert "frames" not in m.snapshot()["series"]


def test_series_and_counters_are_independent_namespaces():
    m = Metrics()
    m.inc("x")
    m.observe("x", 7.0)
    snap = m.snapshot()
    assert snap["counters"]["x"] == 1
    assert snap["series"]["x"]["count"] == 1


@pytest.mark.parametrize("window", [1, 5, 64])
def test_snapshot_equals_the_reference(window):
    """The port's copy renders the same snapshot as the reference's for
    the same counters and samples."""
    rng = np.random.default_rng(window)
    ours, ref = Metrics(window=window), RefMetrics(window=window)
    for m in (ours, ref):
        m.inc("frames", 3)
        m.inc("steps")
    for v in rng.exponential(size=40):
        ours.observe("latency", v)
        ref.observe("latency", v)
    assert ours.snapshot() == ref.snapshot()
