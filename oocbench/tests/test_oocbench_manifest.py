"""BENCHMARK.json against the contract, and the result line's keys."""
import copy
import json

import pytest

from oocbench import manifest, run as R


def _manifest():
    return R.load_manifest()


def test_committed_manifest_is_sound():
    assert manifest.problems(_manifest(), R.ROOT) == []


@pytest.mark.parametrize("breach", [
    ("workloads", 0, "name", "has space"),
    ("end_to_end", 0, "unit", "GFLOP per s"),
    ("per_layer", 0, "moves", "no_such_metric"),
    ("workloads", 0, "config", "no_such_config"),
    ("workloads", 0, "traffic", "no_such_mix"),
    ("per_layer", 0, "source", "guess"),
    ("end_to_end", 0, "bound", 0.5),
])
def test_breaches_are_found(breach):
    group, i, key, value = breach
    m = copy.deepcopy(_manifest())
    m[group][i][key] = value
    assert manifest.problems(m, R.ROOT)


def test_four_chip_share_is_capped():
    m = copy.deepcopy(_manifest())
    for w in m["workloads"][:2]:
        w["chips"] = 4
    assert any("four chips" in p for p in manifest.problems(m, R.ROOT))


def test_a_metric_whose_cell_lacks_what_it_moves_is_found():
    m = copy.deepcopy(_manifest())
    m["end_to_end"][0]["workloads"] = [m["workloads"][0]["name"]]
    assert manifest.problems(m, R.ROOT)


def test_every_cell_resolves_to_an_entry_and_readers():
    m = _manifest()
    for w in m["workloads"]:
        cell, config, mix = R.resolve(m, w["name"])
        entry = R.entry_module(mix["entry"])
        for fn in ("make", "open_operands", "call", "sample_shape",
                   "positions", "poison", "read", "expected"):
            assert callable(getattr(entry, fn))
        assert {"rel_err"} <= set(mix["limits"])
        assert mix["control"]
        for trace in (False, True):
            names = [n for n, _ in R.cell_metrics(m, w["name"], trace)]
            assert names
            for n in names:
                assert callable(R.metric_reader(n))
    gflops_cells = {e["name"]: e for e in m["end_to_end"]}["gflops"][
        "workloads"]
    for w in m["workloads"]:
        names = {n for n, _ in R.cell_metrics(m, w["name"], False)}
        assert "setup_s" in names
        assert ("gflops" in names) == (w["name"] in gflops_cells)


def test_result_line_keys_and_order():
    rec = {"attempted": 3, "failed": 0, "work_passed": 6e9, "window_s": 2.0,
           "setup_s": 9.5, "host_peak_bytes": 2**31,
           "device_peak_bytes": 2**30, "trace": None,
           "checks": {"rel_err": {"value": 1e-7, "limit": 1e-5},
                      "failed_calls": {"value": 0, "limit": 0},
                      "judged_calls": {"value": 3, "limit": 1}}}
    line = R.result_line(rec, [("gflops", "GFLOP/s"), ("setup_s", "s"),
                               ("host_peak_gib", "GiB")],
                         {"platform": "gpu"}, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["gflops"] == {"value": 3.0, "unit": "GFLOP/s"}
    assert line["metrics"]["host_peak_gib"]["value"] == 2.0
    json.dumps(line)
    rec["failed"] = 1
    assert R.result_line(rec, [], {}, False)["correct"] is False
