"""Lightweight counters/metrics stream.

The reference emits an ad-hoc metrics stream as cache log lines
(ALLOC/DEALLOC/COMMIT/EVICT/HIT/MISS with running sizes, cache.cpp:82-233).
Here it is a real counter registry that subsystems bump and benchmarks dump.
"""
from __future__ import annotations

import collections
import threading


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = collections.defaultdict(float)
        self._samples: dict[str, list] = collections.defaultdict(list)

    def add(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] += value

    def set(self, name: str, value: float):
        with self._lock:
            self._counters[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def observe(self, name: str, value: float):
        """Append one sample to a distribution series (e.g. per-tile
        transfer rates) — lets benchmarks report first/median/last and
        expose in-run drift, not just totals."""
        with self._lock:
            self._samples[name].append(float(value))

    def samples(self, name: str) -> list:
        with self._lock:
            return list(self._samples.get(name, ()))

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._samples.clear()


METRICS = Metrics()
