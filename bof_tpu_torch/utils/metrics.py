"""Lightweight counters/metrics stream.

The reference emits an ad-hoc metrics stream as cache log lines
(ALLOC/DEALLOC/COMMIT/EVICT/HIT/MISS with running sizes, cache.cpp:82-233).
Here it is a real counter registry that subsystems bump and benchmarks
dump.  `span` times a stage: it books the stage's seconds (and bytes) as
counters and, while spans are switched on (utils/profiling.set_spans),
records a torch.profiler range on the calling thread.
"""
from __future__ import annotations

import collections
import functools
import threading
import time

from . import profiling


class Span:
    """One timed stage, `with METRICS.span("gemm.h2d", nbytes) as sp:`.
    At exit it adds the elapsed seconds to `<name>_s` and `nbytes` (which
    the body may set as `sp.nbytes`) to `<name>_bytes`, and leaves the
    seconds in `sp.seconds`.  With spans on, the body also runs inside
    `torch.profiler.record_function(name)`; with them off nothing imports
    torch.profiler.  `metrics` None books no counters (profiling.annotate).
    As a decorator, `@METRICS.span("gemm")`, each call runs in a span of
    its own."""

    __slots__ = ("_metrics", "name", "nbytes", "seconds", "_t0", "_range")

    def __init__(self, metrics, name: str, nbytes: int = 0):
        self._metrics = metrics
        self.name = name
        self.nbytes = nbytes
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if profiling.spans_on:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._metrics is not None:
            self._metrics._book(self.name, self.seconds, self.nbytes)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with Span(self._metrics, self.name, self.nbytes):
                return fn(*args, **kwargs)
        return spanned


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = collections.defaultdict(float)
        self._samples: dict[str, list] = collections.defaultdict(list)

    def add(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] += value

    def span(self, name: str, nbytes: int = 0) -> Span:
        """A timed stage booking `<name>_s` (and `<name>_bytes`)."""
        return Span(self, name, nbytes)

    def _book(self, name: str, seconds: float, nbytes: int) -> None:
        with self._lock:
            self._counters[name + "_s"] += seconds
            if nbytes:
                self._counters[name + "_bytes"] += nbytes

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
