"""The port's utility layer (`bof_tpu_torch/utils/{alignment,metrics,timer,
logger,profiling}.py`) against bof_tpu's, case for case after
tests/test_utils.py: each case runs on both packages and must give the
same values and the same behaviour.  (test_utils.py's two compile-cache
cases test JAX's cache, which the port has no counterpart of.)"""
import logging
import time

import pytest

from torch_pair import BOTH, run_both


def test_alignment_math():
    def values(pk):
        u = pk.mod("utils")
        return (u.round_up(1, 512), u.round_up(512, 512),
                u.round_down(1023, 512), u.cdiv(10, 3), u.cdiv(9, 3),
                u.is_sector_aligned(1024), u.is_sector_aligned(1000),
                [u.round_up(x, 4096) for x in (0, 1, 4095, 4097, 1 << 40)])
    ref, port = run_both(values)
    assert port == ref
    assert port[:7] == (512, 512, 512, 4, 3, True, False)


def test_fnv64a_known_vector():
    ref, port = run_both(lambda pk: [pk.mod("utils").fnv64a(s) for s in (
        b"", b"a", b"foobar", bytes(range(256)))])
    assert port == ref
    assert port[:2] == [0xCBF29CE484222325, 0xAF63DC4C8601EC8C]


def test_metrics_counters():
    def trace(pk):
        m = pk.mod("utils").Metrics()
        m.add("x")
        m.add("x", 2.5)
        m.set("y", 7)
        seen = [m.get("x"), m.snapshot()]
        m.reset()
        return seen + [m.get("x"), m.snapshot()]
    ref, port = run_both(trace)
    assert port == ref
    assert port[:2] == [3.5, {"x": 3.5, "y": 7}] and port[2] == 0.0


def test_timer_monotonic():
    for pk in BOTH:
        t = pk.mod("utils").Timer()
        time.sleep(0.01)
        assert 5 <= t.elapsed_ms() < 5000, pk
        t.reset()
        assert t.elapsed_ms() < 5000, pk


def test_fatal_raises():
    errors = []
    for pk in BOTH:
        logger = pk.mod("utils.logger")
        with pytest.raises(logger.FlashFatal) as e:
            logger.fatal("boom %d", 42)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


def test_logger_levels():
    names = []
    for pk in BOTH:
        log = pk.mod("utils").get_logger("bof.test")
        assert isinstance(log, logging.Logger)
        log.info("info line")  # must not raise
        names.append((log.name, log.level, log.propagate))
    assert names[0] == names[1]


def test_trace_without_profiler_logs_the_region():
    """Without a log directory both packages' `trace` run the region and
    log its wall time at debug level on their LOG."""
    import numpy as np
    got = []
    for pk in BOTH:
        log = pk.mod("utils").LOG
        records = []
        handler = logging.Handler(logging.DEBUG)
        handler.emit = records.append
        level = log.level
        log.addHandler(handler)
        log.setLevel(logging.DEBUG)
        try:
            with pk.mod("utils.profiling").trace("region"):
                x = np.ones(10).sum()
        finally:
            log.removeHandler(handler)
            log.setLevel(level)
        got.append((x, [r.getMessage().split(":")[0] for r in records]))
    assert got[0] == got[1] == (10, ["trace[region]"])
