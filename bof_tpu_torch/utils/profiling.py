"""Profiling hooks (the port of `bof_tpu/utils/profiling.py`).

The reference's tracing is log-based Timers around hot paths (SURVEY §5).
`trace()` wraps a region in a `torch.profiler` trace of the host and the
card that Chrome's trace viewer (or Perfetto) opens; without `log_dir` it
logs the region's wall time.  `annotate()` names a region inside an
active trace.
"""
from __future__ import annotations

import contextlib
import os

from .logger import LOG
from .timer import Timer


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Profile a region: `with trace("gemm", "/tmp/prof"):` writes
    `<log_dir>/<name>.<pid>.trace.json`; without log_dir it just logs wall
    time."""
    t = Timer()
    if log_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(name):
                yield
        prof.export_chrome_trace(
            os.path.join(log_dir, f"{name}.{os.getpid()}.trace.json"))
    else:
        yield
    LOG.debug("trace[%s]: %.1f ms", name, t.elapsed_ms())


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside an active profiler trace."""
    from torch.profiler import record_function
    with record_function(name):
        yield
