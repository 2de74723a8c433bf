"""Whole runs on the CPU at tiny sizes (the port's plain kernels), the
refusal without a card, and the modules a run loads."""
import json
import os
import subprocess
import sys

import pytest

from oocbench import run as R
from oocbench.tests.tiny import run_tiny


@pytest.mark.parametrize("entry", ["gemm", "csrgemv", "csrmm"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(entry, trace):
    rec, line = run_tiny(entry, trace=trace)
    assert line["correct"] is True, rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert rec["checks"]["judged_calls"]["value"] == rec["attempted"]
    assert rec["checks"]["rel_err"]["value"] < 1e-5
    assert rec["window_s"] > 0 and rec["setup_s"] > 0
    assert rec["host_peak_bytes"] > 0
    assert rec["io"]["write_bytes"] >= 0
    pc = rec["pin_cache"]
    assert pc["misses"] >= 0 and pc["miss_bytes"] >= 0
    assert (pc["misses"] == 0) == (pc["miss_bytes"] == 0)
    assert (rec["trace"] is not None) == trace
    if trace:
        assert list(line)[-2:] == ["breakdown", "checks"]
    assert not os.path.exists(os.path.join(R.ROOT, "build", "oocbench",
                                           "runs", str(os.getpid())))


def test_the_measuring_path_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "oocbench.run", "--workload",
         "sgemm_fig5.flash", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=R.ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_an_unknown_workload_is_refused():
    with pytest.raises(R.Refused):
        R.resolve(R.load_manifest(), "no_such.cell")


def test_a_run_loads_no_jax_and_no_bof_tpu():
    code = (
        "import json, sys; from oocbench import run as R\n"
        "from oocbench.tests.tiny import run_tiny\n"
        "rec, line = run_tiny('csrgemv', trace=True)\n"
        "assert line['correct']\n"
        "print(json.dumps(R.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bof_tpu_torchlike", object())
    assert "bof_tpu_torchlike" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert R.forbidden_modules() == ["jax.numpy"]


def test_run_dir_removes_those_of_ended_runs():
    base = os.path.join(R.ROOT, "build", "oocbench", "runs")
    os.makedirs(os.path.join(base, "999999999"), exist_ok=True)
    path = R.run_dir(R.ROOT)
    try:
        assert not os.path.exists(os.path.join(base, "999999999"))
        assert os.path.basename(path) == str(os.getpid())
    finally:
        os.rmdir(path)
