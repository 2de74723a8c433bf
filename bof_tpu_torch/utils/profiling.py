"""Profiling hooks (the port of `bof_tpu/utils/profiling.py`).

The reference's tracing is log-based Timers around hot paths (SURVEY §5).
Here the port's stages run inside `METRICS.span`s (utils/metrics.py),
which always book their seconds and bytes as counters and, while spans
are switched on (`set_spans`), also record a `torch.profiler` range on
their own thread.  `trace()` switches them on for a region and profiles
the host (every thread) and the card into a Chrome trace that Chrome's
trace viewer (or Perfetto) opens; without `log_dir` it logs the region's
wall time.  `annotate()` is a span without counters.
"""
from __future__ import annotations

import contextlib
import os

from .logger import LOG
from .timer import Timer

spans_on = False
"""Whether spans also record a torch.profiler range (set by `set_spans`)."""


def set_spans(on: bool) -> bool:
    """Switch the spans' profiler ranges on or off; returns the previous
    setting.  A profiler that should see the ranges of threads other than
    its own records every thread (`profile_all_threads`, as `trace`)."""
    global spans_on
    prev, spans_on = spans_on, bool(on)
    return prev


def all_threads_config():
    """The torch.profiler config that records the host events of every
    thread, not only of the thread that started the profiler."""
    from torch._C._profiler import _ExperimentalConfig
    return _ExperimentalConfig(profile_all_threads=True)


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Profile a region: `with trace("gemm", "/tmp/prof"):` writes
    `<log_dir>/<name>.<pid>.trace.json`, with the spans of every thread;
    without log_dir it just logs wall time."""
    t = Timer()
    if log_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prev = set_spans(True)
        try:
            with profile(activities=acts,
                         experimental_config=all_threads_config()) as prof:
                with annotate(name):
                    yield
        finally:
            set_spans(prev)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"{name}.{os.getpid()}.trace.json"))
    else:
        yield
    LOG.debug("trace[%s]: %.1f ms", name, t.elapsed_ms())


def annotate(name: str):
    """Named region inside an active trace: a span that books no
    counters."""
    from .metrics import Span
    return Span(None, name)
