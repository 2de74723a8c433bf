"""The benchmark's pieces for the eigensolver cell and the streaming XML
cell, on the CPU: the readers `transpose_share` and `gram_k2_roofline` on
synthetic records, the plain reference `oocbench/reference/gram.py`
against scipy in float64, the `eig` entry driven through a whole run of a
tiny cell (the port's plain kernels), its control failing the limit, each
judged row held at its own scale, A judged as set-up wrote it, a program
without `apply_gram` refused before anything is made, and the two cells'
files as `BENCHMARK.json` declares them."""
import json
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from oocbench import peaks, run as R
from oocbench.reference import gram

TINY = {"docs": 600, "vocab": 30000, "nnz_per_doc_mean": 20,
        "nnz_per_doc_max": 200, "block": 8}


def _mix(name):
    with open(os.path.join(R.HERE, "mixes", name + ".json")) as f:
        return json.load(f)


def _tiny():
    """The eig cell's configuration and mix at a CPU size."""
    _, config, mix = R.resolve(R.load_manifest(), "eig_large.gram200")
    config.update(TINY)
    mix["flash_config"] = {"max_nnzs": 2048}
    return config, mix


POOL = {"eig.band_threads": 24.0, "eig.op_applies": 3.0}  # 8 threads


@pytest.mark.parametrize("counters,want", [
    ({"eig.transpose_s": 204.0}, 50.0),
    ({"eig.transpose_s": 612.0, "eig.prep_s": 3.0}, 150.0),
    ({"eig.transpose_s": 0.0}, 0.0),
    ({"eig.transpose_s": 25.5, "eig.band_threads": 3.0}, 50.0),  # 1 thread
])
def test_transpose_share_of_the_window(counters, want):
    """The pool's thread seconds over its threads a call and the window:
    8 threads transposing for the whole window read 100 %."""
    read = R.metric_reader("transpose_share")
    assert read({"counters": {**POOL, **counters}, "window_s": 51.0}) == \
        pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {}, {"eig.prep_s": 9.0}, {"xml_rank.prep_s": 9.0},
    {"eig.transpose_s": 9.0},                           # threads uncounted
    {"eig.transpose_s": 9.0, "eig.band_threads": 8.0}])
def test_transpose_share_reads_nothing_without_the_stage(counters):
    read = R.metric_reader("transpose_share")
    assert read({"counters": counters, "window_s": 51.0}) is None


@pytest.mark.parametrize("counters,want", [
    ({**POOL, "eig.prep_s": 102.0}, 25.0),
    ({**POOL, "eig.prep_s": 0.0, "eig.transpose_s": 9.0}, 0.0),
    ({**POOL, "xml_rank.prep_s": 9.0}, None),
    ({"eig.prep_s": 9.0}, None)])
def test_eig_prep_share_is_a_share_of_the_pool(counters, want):
    """prep_share.eig: the forward banding's thread seconds over the
    pool's threads a call and the window, as transpose_share."""
    got = R.metric_reader("prep_share.eig")({"counters": counters,
                                            "window_s": 51.0})
    assert got == (None if want is None else pytest.approx(want))


def test_gram_k2_roofline_counts_the_operators_work():
    """The operator's bytes (A twice, V once, W out and in, U once) and
    operations (4 nnz b) at 3.35 TB/s and 67 TFLOP/s over all K2 seconds,
    whatever bands carried them."""
    shape = {"m": 524288, "k": 2270000, "n": 200, "nnz": 142_500_000}
    nbytes = (16.0 * shape["nnz"] + 8.0 * shape["k"] * shape["n"]
              + 8.0 * shape["m"] * shape["n"])
    bound = max(nbytes / peaks.HBM_BPS,
                4.0 * shape["nnz"] * shape["n"] / peaks.FP32_FLOPS)
    kernels = {"spmm_ell_kernel<float, 64>": [0.3, 40],
               "spmm_ell_kernel<unsigned short, 64>": [0.1, 400],
               "row_topk_kernel": [5.0, 1]}
    rec = {"trace": {"kernels": kernels}, "shape": shape, "attempted": 8}
    got = R.metric_reader("gram_k2_roofline")(rec)
    assert got == pytest.approx(100.0 * bound * 8 / 0.4)
    assert bound == pytest.approx(nbytes / peaks.HBM_BPS)  # bytes bound


@pytest.mark.parametrize("trace", [None, {"kernels": {}},
                                   {"kernels": {"row_topk_kernel": [1, 1]}}])
def test_gram_k2_roofline_reads_nothing_without_k2_time(trace):
    rec = {"trace": trace, "shape": {"m": 1, "k": 1, "n": 1, "nnz": 1},
           "attempted": 1}
    assert R.metric_reader("gram_k2_roofline")(rec) is None


def test_gram_reference_matches_scipy_in_float64():
    """U[words] = A^T (A V) rows against scipy's float64 products, and the
    order of the words asked for (repeats too) kept."""
    rng = np.random.default_rng(11)
    a = sps.random(300, 500, density=0.03, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(2))
    v = rng.standard_normal((500, 6)).astype(np.float32)
    want = a.T.astype(np.float64) @ (a.astype(np.float64)
                                     @ v.astype(np.float64))
    words = np.array([499, 3, 3, 250, 0, 17])
    got = gram.gram_rows(torch.from_numpy(a.indptr.astype(np.int64)),
                         torch.from_numpy(a.indices.astype(np.int64)),
                         torch.from_numpy(a.data), torch.from_numpy(v),
                         words).numpy()
    np.testing.assert_allclose(got, want[words], rtol=1e-12, atol=1e-12)
    dense = a.toarray().astype(np.float64)
    np.testing.assert_allclose(
        gram.svdvals(torch.from_numpy(a.indptr.astype(np.int64)),
                     torch.from_numpy(a.indices.astype(np.int64)),
                     torch.from_numpy(a.data), 500).numpy(),
        np.linalg.svd(dense, compute_uv=False), rtol=1e-12)


def test_eig_entry_runs_a_tiny_cell_correctly():
    """A whole run of a tiny eig cell on the CPU: every call judged and
    correct, the operator's counters and spans booked, the cell's
    per-layer readers reading, each call's work 4 nnz b."""
    config, mix = _tiny()
    rec = R.run(config, mix, 2**31 + 5, 0.5, False, device="cpu",
                log=lambda s: None)
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert rec["checks"]["rel_err"]["value"] <= 1e-6
    assert rec["work_per_call"] == 4.0 * rec["shape"]["nnz"] * TINY["block"]
    c = rec["counters"]
    calls = rec["attempted"]
    assert c["eig.op_applies"] == calls
    assert c["eig.d2h_bytes"] == calls * TINY["vocab"] * TINY["block"] * 8
    for span in ("apply", "disk_wait", "prep", "transpose", "band_wait",
                 "h2d", "dispatch", "fold", "d2h", "write"):
        assert c["eig." + span + "_s"] > 0, span
    assert 0 < c["eig.t_rows"] < c["eig.fwd_bands"] * TINY["vocab"]
    assert c["eig.band_threads"] >= calls
    for name in ("prep_share.eig", "transpose_share", "pin_hit_ratio",
                 "disk_read_gbps"):
        assert R.metric_reader(name)(rec) is not None, name
    assert R.metric_reader("transpose_share")(rec) <= 100.0


def test_eig_control_fails_the_limit():
    """bf16 values on the link (the mix's control) read above the cell's
    limit on the tiny cell; the program reads far below it."""
    config, mix = _tiny()
    rec = R.run(config, mix, 2**31 + 9, 0.3, False, device="cpu",
                overrides=mix["control"], log=lambda s: None)
    assert rec["checks"]["rel_err"]["value"] > mix["limits"]["rel_err"]
    assert rec["failed"] == rec["attempted"] >= 1


def test_each_judged_word_is_held_at_its_own_scale(monkeypatch):
    """A U whose rows of rare words (at most 3 documents) are 1 % off
    fails each call whose sample holds one (the first call's does, at
    this seed), though those rows are far smaller than the frequent
    words': each judged row is compared at its own largest magnitude."""
    import bof_tpu_torch
    config, mix = _tiny()
    real = bof_tpu_torch.apply_gram

    def rare_rows_off(a, v, **kw):
        u = real(a, v, **kw)
        counts = np.bincount(a.ja.read_all(), minlength=u.shape[0])
        u[(counts > 0) & (counts <= 3)] *= 1.01
        return u
    monkeypatch.setattr(bof_tpu_torch, "apply_gram", rare_rows_off)
    rec = R.run(config, mix, 2**31 + 15, 0.3, False, device="cpu",
                log=lambda s: None)
    assert rec["failed"] >= 1
    assert 5e-3 < rec["checks"]["rel_err"]["value"] < 2e-2


def test_the_reference_reads_a_as_set_up_wrote_it(monkeypatch):
    """A is drawn once, at set-up: the judging reads it back from the
    files set-up wrote (a draw on the card places a few words differently
    from one draw to the next)."""
    from oocbench.entries import xml_rank
    config, mix = _tiny()
    draws = []
    real = xml_rank.docs_csr

    def counted(*a, **k):
        draws.append(a[1])
        return real(*a, **k)
    monkeypatch.setattr(xml_rank, "docs_csr", counted)
    rec = R.run(config, mix, 2**31 + 17, 0.2, False, device="cpu",
                log=lambda s: None)
    assert rec["failed"] == 0 and rec["attempted"] >= 1
    assert draws == [2**31 + 17]


def test_a_program_without_apply_gram_is_refused_at_once(monkeypatch):
    """The parent of the operator's PR lacks apply_gram: the entry's make
    raises before it draws or writes anything."""
    import bof_tpu_torch
    config, mix = _tiny()
    monkeypatch.delattr(bof_tpu_torch, "apply_gram")
    drawn = []
    monkeypatch.setattr(
        "oocbench.entries.xml_rank.docs_csr",
        lambda *a, **k: drawn.append(a))
    with pytest.raises(RuntimeError, match="apply_gram"):
        R.run(config, mix, 1, 0.1, False, device="cpu", log=lambda s: None)
    assert drawn == []


def test_the_two_cells_as_declared():
    """eig_large keeps the published widths, the stream mix is top5's at
    Table 6's cache ratio, and the new readers are per-layer metrics of
    the eig cell."""
    m = R.load_manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    for name in ("xml_amazon670k.stream", "eig_large.gram200"):
        assert cells[name]["chips"] == 1
    _, config, mix = R.resolve(m, "eig_large.gram200")
    assert (config["vocab"], config["nnz_per_doc_mean"], config["block"],
            config["kdim"], config["n_vals"]) == (2270000, 272, 200, 800,
                                                  200)
    assert mix["entry"] == "eig" and mix["control"] == {
        "transfer_dtype": "bfloat16"}
    stream, top5 = _mix("xml_stream"), _mix("xml_top5")
    assert stream["program_budget_ratio"] == 0.27
    for key in ("entry", "label_blk", "limits", "control"):
        assert stream[key] == top5[key]
    layers = {p["name"]: p for p in m["per_layer"]}
    assert layers["transpose_share"]["layer"] == "host prep"
    assert layers["prep_share.eig"]["layer"] == "host prep"
    assert layers["gram_k2_roofline"]["layer"] == "kernels"
    for name in ("transpose_share", "gram_k2_roofline", "prep_share.eig"):
        assert layers[name]["workloads"] == ["eig_large.gram200"]
    # thread seconds are read over the pool's threads, never as the
    # window's share a single thread would give
    assert "eig_large.gram200" not in layers["prep_share.unbounded"][
        "workloads"]
    # the stream cell reports its host peak and its kernels' rooflines
    for name in ("host_peak_gib.unbounded", "k2_roofline", "b8_roofline"):
        assert "xml_amazon670k.stream" in layers[name]["workloads"], name
