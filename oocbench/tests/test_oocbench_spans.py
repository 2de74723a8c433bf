"""The traced run with the port's spans (oocbench/spans.py): the booking of
the card's idle gaps to program spans on a synthetic trace, the five
readers of the spans and of the pin cache's read bytes, and whole tiny
runs on the CPU."""
import json

import pytest

from oocbench import run as R
from oocbench import spans, trace
from oocbench.tests.tiny import tiny


def _ev(name, cat, ts, dur, tid=0, **args):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


def _span(name, tid, t0, t1):
    return _ev(name, "user_annotation", t0, t1 - t0, tid)


# A gemm-like window, 0..1000 us: the main thread (1) waits for tiles and
# launches, the producer (2) waits on disk, uploads and preps, the writer
# (3) waits on a queue and downloads.  Device ops at 0-100 (issued by 1),
# 420-500 (by 2), 600-700 (by 1) and 800-900 (no correlation): idle gaps
# 100-420, 500-600, 700-800 and 900-1000 (the window's end).
EVENTS = [
    _ev(trace.WINDOW_SPAN, "user_annotation", 0.0, 1000.0, 1),
    _ev("void accum_tf32_kernel<3>(CUtensorMap_st)", "kernel", 0.0, 100.0,
        7, correlation=3),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 420.0, 80.0, 7,
        correlation=7, bytes=1000),
    _ev("void accum_tf32_kernel<3>(CUtensorMap_st)", "kernel", 600.0, 100.0,
        7, correlation=9),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 800.0, 100.0, 7,
        bytes=1000),
    _ev("cudaLaunchKernel", "cuda_runtime", 0.0, 5.0, 1, correlation=3),
    _ev("cudaMemcpyAsync", "cuda_runtime", 410.0, 90.0, 2, correlation=7),
    _ev("cudaLaunchKernel", "cuda_runtime", 598.0, 5.0, 1, correlation=9),
    _span("gemm", 1, 0.0, 950.0),
    _span("gemm.tile_wait", 1, 100.0, 400.0),
    _span("gemm.tile_wait", 1, 450.0, 600.0),
    _span("gemm.accum", 1, 596.0, 620.0),
    _span("gemm.disk_wait", 2, 50.0, 300.0),
    _span("gemm.h2d", 2, 300.0, 500.0),
    _span("gemm.prep", 2, 480.0, 600.0),
    _span("gemm.queue_wait", 3, 0.0, 650.0),
    _span("gemm.d2h", 3, 650.0, 800.0),
]


def test_the_booking_rule_on_a_synthetic_trace():
    s = spans.summarize(EVENTS)
    booked = s["idle_booked"]
    want = {
        # 100-420 ends with the producer's upload: its own spans (rule 1)
        "gemm.disk_wait": 200e-6, "gemm.h2d": 120e-6,
        # 500-596 ends with a launch from inside a hand-off: the stage
        # open on another thread (rule 2); 596-600 in the launch itself
        "gemm.prep": 96e-6, "gemm.accum": 4e-6,
        # 700-800 ends with a copy of no correlation: rule 2
        "gemm.d2h": 100e-6,
        # 900-1000, the window's end: only the call (rule 3), then none
        "gemm": 50e-6, spans.NO_SPAN: 50e-6,
    }
    assert booked == pytest.approx(want)
    assert sum(booked.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert s["idle_spans"][-1] == [spans.NO_SPAN, pytest.approx(50e-6)]
    assert s["idle_spans"][0] == ["gemm.disk_wait", pytest.approx(200e-6)]
    assert s["spans"]["gemm.tile_wait"] == [pytest.approx(450e-6), 2]
    # trace.summarize's keys keep their rule
    assert s["idle_gaps"] == trace.summarize(EVENTS)["idle_gaps"]


@pytest.mark.parametrize("name, want", [
    ("gemm", "entry"), ("gemm_sharded", "entry"),
    ("gemm.tile_wait", "hand_off"), ("csrmm.queue_wait", "hand_off"),
    ("csrmm.h2d", "stage"), ("csrgemv.disk_wait", "stage")])
def test_kinds_of_span(name, want):
    assert spans.kind(name) == want


def test_innermost_span_of_nested_spans():
    got = spans._innermost([(0, 10, "a"), (2, 5, "b"), (6, 8, "c"),
                            (6, 7, "d")])
    assert got == [(0, 2, "a", 0), (2, 5, "b", 2), (5, 6, "a", 0),
                   (6, 7, "d", 6), (7, 8, "c", 6), (8, 10, "a", 0)]


def test_the_issuing_thread_is_found_through_external_ids():
    """The tracer may give a worker's runtime call the id of an earlier,
    ended thread (9 here): the copy is traced to its thread (5) by the
    `External id` of the torch op that issued it; a kernel launched with
    no torch op, whose runtime call names the ended thread, falls to rule
    2 (thread 6's stage)."""
    events = [
        _ev(trace.WINDOW_SPAN, "user_annotation", 0.0, 100.0, 1),
        _span("x.prep", 6, 0.0, 90.0),
        _span("x.h2d", 5, 10.0, 60.0),
        _ev("aten::copy_", "cpu_op", 50.0, 10.0, 5, **{"External id": 42}),
        _ev("cudaMemcpyAsync", "cuda_runtime", 55.0, 5.0, 9, correlation=3,
            **{"External id": 42}),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60.0, 10.0, 7,
            correlation=3, **{"External id": 42}),
        _ev("cudaLaunchKernel", "cuda_runtime", 75.0, 2.0, 9,
            correlation=4),
        _ev("k", "kernel", 80.0, 10.0, 7, correlation=4),
    ]
    booked = spans.summarize(events)["idle_booked"]
    assert booked == pytest.approx({
        "x.prep": 10e-6 + 10e-6, "x.h2d": 50e-6, spans.NO_SPAN: 10e-6})


def test_a_gap_with_no_span_at_all():
    events = [_ev(trace.WINDOW_SPAN, "user_annotation", 0.0, 100.0, 1),
              _ev("k", "kernel", 50.0, 10.0, 7, correlation=1),
              _ev("cudaLaunchKernel", "cuda_runtime", 40.0, 5.0, 1,
                  correlation=1)]
    booked = spans.summarize(events)["idle_booked"]
    assert booked == pytest.approx({spans.NO_SPAN: 90e-6})


def _rec(**kw):
    rec = {"entry": "gemm", "window_s": 1e-3, "pin_read_bytes": 4_000_000,
           "trace": spans.summarize(EVENTS)}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name, want", [
    ("card_wait_disk", 20.0), ("card_wait_prep", 9.6),
    ("card_wait_h2d", 12.0), ("card_wait_d2h", 10.0),
    ("pin_read_gbps", 4.0)])
def test_the_new_readers(name, want):
    assert R.metric_reader(name)(_rec()) == pytest.approx(want)
    # where the run recorded no spans or no read bytes: nothing, no raise
    assert R.metric_reader(name)(_rec(
        trace=trace.summarize(EVENTS), pin_read_bytes=None)) is None
    assert R.metric_reader(name)(_rec(
        trace=None, pin_read_bytes=None)) is None


def test_card_waits_sum_to_no_more_than_the_idle_share():
    rec = _rec()
    waits = sum(R.metric_reader(f"card_wait_{w}")(rec)
                for w in ("disk", "prep", "h2d", "d2h"))
    idle = 100.0 * (1 - rec["trace"]["busy_s"] / rec["trace"]["window_s"])
    assert waits <= idle


@pytest.mark.parametrize("entry", ["gemm", "csrgemv", "csrmm"])
def test_a_tiny_traced_run_books_every_idle_second(entry):
    """On the CPU no device op runs: the whole window is one idle gap at
    the window's end, booked by rules 2-4 to the stages the pipelines'
    threads ran."""
    config, mix = tiny(entry)
    rec = spans.traced_run(config, mix, 2**31 + 91, 0.5, device="cpu",
                           log=lambda s: None)
    t = rec["trace"]
    assert sum(t["idle_booked"].values()) == pytest.approx(
        t["window_s"] - t["busy_s"], rel=1e-6)
    assert t["spans"][entry][1] >= 1
    assert f"{entry}.disk_wait" in t["spans"]
    assert rec["pin_read_bytes"] >= 0
    out = spans.line(rec, [], {"platform": "cpu"})
    assert out["correct"] is True
    assert set(out["metrics"]) == {n for n, _ in spans.NEW}
    assert out["breakdown"]["idle_spans"][-1][0] == spans.NO_SPAN
    json.dumps(out)
    # the swapped hooks are back
    assert trace.start is not spans.start
    assert R.native_pin_cache.__module__ == "oocbench.run"
