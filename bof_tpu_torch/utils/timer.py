"""Millisecond stopwatch (reference: include/bof_timer.h:8-27)."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0
