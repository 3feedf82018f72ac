"""Lightweight serving metrics: counters and windowed timers (the port's
own copy of ``repro.serve.metrics``, which is pure Python).

The request plane (``repro_torch.serve.frontend``) and the fleet need a
handful of operational numbers — queue depth, coalesce factor, tier
hits, park/resume events, per-frame latency — without a metrics
dependency.  ``Metrics`` keeps monotonic counters plus bounded sample
windows and renders everything as one plain ``snapshot()`` dict
(JSON-ready).

Quantiles are computed over the most recent ``window`` samples per
series (a ring buffer, so a long-lived server's memory stays bounded);
``count``/``sum``/``min``/``max`` are exact over the full lifetime.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class _Series:
    """One observed series: exact lifetime aggregates + a quantile ring."""

    window: int
    count: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = float("-inf")
    ring: collections.deque = None  # type: ignore[assignment]

    def __post_init__(self):
        self.ring = collections.deque(maxlen=self.window)

    def add(self, value: float) -> None:
        """Fold one sample into the aggregates and the quantile window."""
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.ring.append(v)

    def summary(self) -> dict:
        """count/mean/min/max (lifetime) + p50/p90/p99 (recent window)."""
        q = np.percentile(np.fromiter(self.ring, float),
                          [50, 90, 99]) if self.ring else [0.0] * 3
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
        }


class Metrics:
    """A named bag of counters and sample series.

    ``inc`` bumps a monotonic counter; ``observe`` records one sample of
    a distribution (latency seconds, batch sizes, queue depths, ...).
    ``snapshot`` renders both as a nested plain dict.  Single-threaded
    by design: the request plane touches it only from the event loop /
    scheduler, never from worker threads.
    """

    def __init__(self, window: int = 4096):
        self._window = window
        self._counters: dict[str, float] = collections.defaultdict(float)
        self._series: dict[str, _Series] = {}

    def inc(self, name: str, value: float = 1) -> None:
        """Add ``value`` (default 1) to counter ``name``."""
        self._counters[name] += value

    def observe(self, name: str, value: float) -> None:
        """Record one sample of series ``name``."""
        series = self._series.get(name)
        if series is None:
            series = self._series[name] = _Series(self._window)
        series.add(value)

    def counter(self, name: str) -> float:
        """Current value of counter ``name`` (0 if never incremented)."""
        return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """``{"counters": {...}, "series": {name: summary, ...}}`` —
        plain floats/ints throughout, safe to ``json.dump``."""
        return {
            "counters": dict(self._counters),
            "series": {k: s.summary() for k, s in self._series.items()},
        }
