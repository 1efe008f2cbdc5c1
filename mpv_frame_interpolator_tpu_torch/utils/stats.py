"""Named value series with rolling windows for percentile reporting (the
port's copy of the JAX package's ``utils/stats.py``)."""

from __future__ import annotations

import collections
from typing import Dict


class _Series:
    __slots__ = ("window", "total", "count")

    def __init__(self, maxlen: int):
        self.window = collections.deque(maxlen=maxlen)
        self.total = 0.0
        self.count = 0

    def add(self, v: float):
        self.window.append(v)
        self.total += v
        self.count += 1

    @property
    def last(self) -> float:
        return self.window[-1] if self.window else 0.0

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        if not self.window:
            return 0.0
        vals = sorted(self.window)
        idx = min(int(len(vals) * p / 100.0), len(vals) - 1)
        return vals[idx]


class StatsRegistry:
    """Named value series (seconds)."""

    def __init__(self, window: int = 256):
        self._series: Dict[str, _Series] = {}
        self._window = window

    def series(self, name: str) -> _Series:
        if name not in self._series:
            self._series[name] = _Series(self._window)
        return self._series[name]

    def add(self, name: str, value: float):
        self.series(name).add(value)

    def last(self, name: str) -> float:
        """The latest value of `name` (0 if none)."""
        s = self._series.get(name)
        return s.last if s is not None else 0.0

    def count(self, name: str) -> int:
        """How many values `name` has had (0 if none)."""
        s = self._series.get(name)
        return s.count if s is not None else 0

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"last": s.last, "mean": s.mean(),
                "p50": s.percentile(50), "p99": s.percentile(99),
                "count": s.count}
            for k, s in self._series.items()
        }
