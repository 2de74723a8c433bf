"""The cell xml_amazon670k.top5 at a tiny size on the CPU (the port's
plain kernels): a run is correct, and `correct` comes out false when the
timed path answers from the earlier quarter, swaps two labels, or drops a
label panel, and under the control (bf16 values on the link); its
readers; and the manifest with the cells this benchmark gained."""
import copy
import importlib
import json
import os

import numpy as np
import pytest
import torch

from oocbench import manifest, run as R
from oocbench.reference import xml_ovr

XML = {"vocab": 1001, "labels": 203, "docs": 400, "k": 5,
       "nnz_per_doc_mean": 24, "nnz_per_doc_sigma": 1.0,
       "nnz_per_doc_max": 2000, "zipf_exponent": 1.0}
PANEL = 64


def _tiny():
    """(configuration, mix) of a tiny xml cell, with the committed
    mix's limit and control."""
    with open(os.path.join(R.HERE, "mixes", "xml_top5.json")) as f:
        mix = json.load(f)
    mix["label_blk"] = PANEL
    return copy.deepcopy(XML), mix


def _run(seed=2**31 + 91, trace=False, overrides=None):
    config, mix = _tiny()
    rec = R.run(config, mix, seed, 0.5, trace, device="cpu",
                overrides=overrides, log=lambda s: None)
    line = R.result_line(rec, [("gflops", "GFLOP/s"),
                               ("w_upload_share", "%")],
                         {"platform": "cpu"}, trace)
    return rec, line


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_xml_run_is_correct(trace):
    rec, line = _run(trace=trace)
    assert line["correct"] is True, rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert rec["checks"]["judged_calls"]["value"] == rec["attempted"]
    assert rec["checks"]["rel_err"]["value"] < 1e-6
    # every pin of the window hits: the warm-up took every quarter
    pc = rec["pin_cache"]
    assert pc["misses"] == 0 and pc["hits"] > 0
    assert rec["counters"]["xml_rank.w_h2d_s"] > 0
    assert "w_upload_share" in line["metrics"]
    panels = -(-XML["labels"] // PANEL)
    assert rec["counters"]["xml_rank.d2h_bytes"] == pytest.approx(
        rec["attempted"] * XML["docs"] // 4 * XML["k"] * 8 * panels)


def _fault(monkeypatch, kind):
    import bof_tpu_torch
    xml_mod = importlib.import_module("bof_tpu_torch.apps.xml_rank")
    if kind == "stale":
        # each call answers for the quarter the call before it scored
        real, last = bof_tpu_torch.xml_rank, {}

        def stale(a, w, k, **kw):
            prev = last.get("a", a)
            last["a"] = a
            return real(prev, w, k, **kw)
        monkeypatch.setattr(bof_tpu_torch, "xml_rank", stale)
    elif kind == "swapped":
        # B8's first two labels trade places, the scores stay
        real = xml_mod.row_topk

        def swapped(s, mask, k):
            vals, idx = real(s, mask, k)
            return vals, idx[:, [1, 0] + list(range(2, k))]
        monkeypatch.setattr(xml_mod, "row_topk", swapped)
    elif kind == "dropped":
        # the second label panel's candidates never reach the merge
        real = xml_mod._merge_topk

        def dropped(scores, labels, r0, s_new, l_new, k, first):
            if PANEL <= l_new.min() and l_new.max() < 2 * PANEL:
                return
            real(scores, labels, r0, s_new, l_new, k, first)
        monkeypatch.setattr(xml_mod, "_merge_topk", dropped)


@pytest.mark.parametrize("kind", ["stale", "swapped", "dropped"])
def test_a_broken_xml_path_is_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    rec, line = _run()
    assert rec["attempted"] >= 1
    assert line["correct"] is False, rec["checks"]


def test_bf16_values_fail_the_xml_limit():
    config, mix = _tiny()
    rec, line = _run(overrides=mix["control"])
    assert line["correct"] is False
    assert rec["checks"]["rel_err"]["value"] > \
        rec["checks"]["rel_err"]["limit"]


def test_the_documents_are_zipf_skewed_and_without_repeats():
    entry = R.entry_module("xml_rank")
    cfg = dict(XML, docs=3000)
    ia, ja, va = entry.docs_csr(cfg, 2**40 + 7, "cpu")
    again = entry.docs_csr(cfg, 2**40 + 7, "cpu")
    assert all(torch.equal(x, y) for x, y in zip((ia, ja, va), again))
    ia, ja = ia.numpy(), ja.numpy()
    lengths = np.diff(ia)
    assert lengths.min() >= 1 and len(ja) == len(va) == ia[-1]
    assert abs(lengths.mean() / cfg["nnz_per_doc_mean"] - 1) < 0.1
    for r in range(cfg["docs"]):
        assert (np.diff(ja[ia[r]:ia[r + 1]]) > 0).all()
    hits = np.sort(np.bincount(ja, minlength=cfg["vocab"]))[::-1]
    assert hits[:10].sum() > 0.15 * len(ja)  # the Zipf head


def test_the_reference_scores_match_numpy():
    import scipy.sparse as sps
    entry = R.entry_module("xml_rank")
    ia, ja, va = entry.docs_csr(XML, 5, "cpu")
    w = torch.randn((XML["labels"], XML["vocab"]), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(3))
    sp = sps.csr_matrix((va.numpy().astype(np.float64), ja.numpy(),
                         ia.numpy()), shape=(XML["docs"], XML["vocab"]))
    rows = np.array([7, 0, 399, 150])
    want = (sp @ w.numpy().astype(np.float64).T)[rows]
    got = xml_ovr.scores(ia, ja, va, w, rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    top = xml_ovr.top_k(torch.from_numpy(got), 5).numpy()
    np.testing.assert_array_equal(top, -np.sort(-want, axis=1)[:, :5])


def _trace_rec():
    return {"attempted": 2, "window_s": 4.0,
            "counters": {"xml_rank.w_h2d_s": 1.0},
            "shape": {"m": 100, "n": 1000, "k": 4096, "label_blk": 500,
                      "top_k": 5},
            "trace": {"kernels": {
                "row_topk_reg_kernel<true>": [1e-3, 4],
                "row_topk_kernel<true>": [1e-3, 1],
                "accum_lowp_kernel<1, float>": [2e-3, 8],
                "pack_kernel<unsigned char, true>": [2e-3, 8],
                "pack_kernel<unsigned short, true>": [9.0, 1],
                "accum_lowp_kernel<0, float>": [9.0, 1],
                "spmm_ell_kernel<int, float>": [9.0, 1]}}}


def test_the_new_readers():
    rec = _trace_rec()
    read = R.metric_reader
    assert read("w_upload_share")(rec) == pytest.approx(25.0)
    # 2 calls x 100 rows x 2 panels x (500 x 4 + 5 x 8) B over 2 ms
    want = 2 * 100 * 2 * (500 * 4 + 40) / 3.35e12 / 2e-3 * 100
    assert read("b8_roofline")(rec) == pytest.approx(want)
    # 2 calls x 2 m n k over 1,979 TOPS, over the 's8' product and its
    # pack pass (4 ms), the bf16 variant left out
    want = 2 * 2.0 * 100 * 1000 * 4096 / 1979e12 / 4e-3 * 100
    assert read("k1_s8_roofline")(rec) == pytest.approx(want)
    for name in ("w_upload_share", "b8_roofline", "k1_s8_roofline"):
        assert read(name)({"trace": None, "counters": {}, "window_s": 1,
                           "shape": {}}) is None


def test_the_manifest_with_both_cells_is_sound():
    m = R.load_manifest()
    assert manifest.problems(m, R.ROOT) == []
    cells = {w["name"]: w for w in m["workloads"]}
    assert cells["sgemm_fig5.int8"]["traffic"] == "int8"
    assert cells["xml_amazon670k.top5"]["config"] == "xml_amazon670k"
    x = {n for n, _ in R.cell_metrics(m, "xml_amazon670k.top5", False)}
    assert x == {"gflops", "device_peak_gib", "setup_s"}
    i = {n for n, _ in R.cell_metrics(m, "sgemm_fig5.int8", False)}
    assert i == {"host_peak_gib", "device_peak_gib", "setup_s"}
    x = {n for n, _ in R.cell_metrics(m, "xml_amazon670k.top5", True)}
    assert {"b8_roofline", "w_upload_share", "k2_roofline",
            "pin_hit_ratio", "host_peak_gib.unbounded"} <= x
    i = {n for n, _ in R.cell_metrics(m, "sgemm_fig5.int8", True)}
    assert "k1_s8_roofline" in i
