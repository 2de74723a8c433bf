"""Rooflines, the idle share, copy rates and the other readers on a
synthetic trace and synthetic counters."""
import pytest

from oocbench import peaks, run as R, trace


def _ev(name, cat, ts, dur, **args):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


EVENTS = [
    _ev(trace.WINDOW_SPAN, "user_annotation", 1000.0, 1000.0),
    # before the window: left out
    _ev("void accum_tf32_kernel<3>(CUtensorMap_st)", "kernel", 10.0, 50.0),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1000.0, 100.0,
        bytes=1_000_000),
    _ev("void tf32_split_kernel<true, true, true>(float const*)", "kernel",
        1100.0, 50.0),
    _ev("void (anonymous namespace)::accum_tf32_kernel<3>(CUtensorMap_st)",
        "kernel", 1120.0,
        80.0),  # overlaps the split pass: 1100..1200 busy once
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500.0, 200.0,
        bytes=4_000_000),
    # crosses the window's end: clipped to 1900..2000
    _ev("void spmv_ell_kernel<int, float, 8, true>(float*)", "kernel",
        1900.0, 300.0),
    _ev("aten::copy_", "cpu_op", 1250.0, 200.0),
    _ev("aten::empty", "cpu_op", 1210.0, 5.0),
]


def test_summary_of_a_synthetic_trace():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: 1000-1200, 1500-1700, 1900-2000 = 500 us
    assert s["busy_s"] == pytest.approx(500e-6)
    assert s["copies"]["HtoD"] == pytest.approx([1e6, 100e-6, 1])
    assert s["copies"]["DtoH"] == pytest.approx([4e6, 200e-6, 1])
    assert s["kernels"]["accum_tf32_kernel<3>"] == pytest.approx([80e-6, 1])
    assert s["kernels"]["spmv_ell_kernel<int, float, 8, true>"] == \
        pytest.approx([100e-6, 1])
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # 1200-1500 mostly inside aten::copy_ (200 of 300 us), then 1700-1900
    assert gaps["host in aten::copy_; device next Memcpy DtoH "
                "(Device -> Pageable)"] == pytest.approx(300e-6)
    assert gaps["host in no torch op; device next spmv_ell_kernel<int, "
                "float, 8, true>"] == pytest.approx(200e-6)
    assert len(s["device_ops"]) <= trace.TOP
    assert s["device_ops"][0][0] == "Memcpy DtoH (Device -> Pageable)"


def test_summary_needs_the_window_span():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])


def _rec(**kw):
    rec = {"entry": "gemm", "attempted": 2, "window_s": 4.0,
           "work_passed": 8e12, "setup_s": 12.0,
           "shape": {"m": 2048, "n": 2048, "k": 131072, "nnz": 1000},
           "io": {"read_bytes": 4 * 2**30, "write_bytes": 0, "rchar": 2**30,
                  "wchar": 0},
           "pin_cache": {"hits": 3, "misses": 1, "evictions": 0,
                         "miss_bytes": 4 * 2**30},
           "counters": {"gemm.prep_s": 1.0},
           "host_peak_bytes": 3 * 2**30, "device_peak_bytes": 2**33,
           "trace": trace.summarize(EVENTS)}
    rec.update(kw)
    return rec


def read(name, rec):
    return R.metric_reader(name)(rec)


def test_rates_and_shares():
    rec = _rec()
    assert read("gflops", rec) == pytest.approx(2000.0)
    assert read("disk_read_gbps", rec) == pytest.approx(4 * 2**30 / 4e9)
    assert read("pin_hit_ratio", rec) == pytest.approx(75.0)
    assert read("prep_share", rec) == pytest.approx(25.0)
    assert read("h2d_gbps", rec) == pytest.approx(10.0)
    assert read("d2h_gbps", rec) == pytest.approx(20.0)
    assert read("device_idle", rec) == pytest.approx(50.0)
    assert read("host_peak_gib", rec) == pytest.approx(3.0)
    assert read("device_peak_gib", rec) == pytest.approx(8.0)
    assert read("setup_s", rec) == 12.0


def test_readers_with_nothing_to_read_return_none():
    rec = _rec(trace=None, pin_cache={"hits": 0, "misses": 0,
                                      "evictions": 0, "miss_bytes": 0},
               counters={})
    for name in ("h2d_gbps", "d2h_gbps", "device_idle", "k1_roofline",
                 "spmv_roofline", "k2_roofline", "pin_hit_ratio",
                 "prep_share"):
        assert read(name, rec) is None, name


def test_k1_roofline_counts_the_inputs_work():
    rec = _rec()
    # K1 = split pass 50 us + product 80 us over two calls
    want = 2 * 2.0 * 2048 * 2048 * 131072 / peaks.TF32X3_FLOPS / 130e-6
    assert read("k1_roofline", rec) == pytest.approx(100 * want)


def test_spmv_and_k2_rooflines():
    s = {"m": 100, "k": 50, "n": 4, "nnz": 1000}
    rec = _rec(shape=s, attempted=3)
    spmv_bytes = 8 * 1000 + 4 * 101 + 4 * 50 + 4 * 100
    assert read("spmv_roofline", rec) == pytest.approx(
        100 * 3 * spmv_bytes / peaks.HBM_BPS / 100e-6)
    t = dict(rec["trace"])
    t["kernels"] = {"spmm_ell_kernel<int, float, true>": [2e-6, 3]}
    rec = _rec(shape=s, attempted=3, trace=t)
    k2_bytes = 8 * 1000 + 4 * 101 + 4 * 50 * 4 + 4 * 100 * 4
    k2_flops = 2 * 1000 * 4
    bound = max(3 * k2_bytes / peaks.HBM_BPS, 3 * k2_flops / peaks.FP32_FLOPS)
    assert read("k2_roofline", rec) == pytest.approx(100 * bound / 2e-6)


def test_rel_err_and_non_finite():
    import numpy as np
    want = np.array([1.0, -4.0, 2.0])
    assert R.rel_err(np.array([1.0, -4.0, 2.4]), want) == pytest.approx(0.1)
    assert R.rel_err(np.array([1.0, np.nan, 2.0]), want) == float("inf")
