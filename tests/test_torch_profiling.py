"""utils/profiling (the port of bof_tpu/utils/profiling.py) against
tests/test_utils.py:60: `trace` without a log directory is a logged timer,
with one it writes a Chrome trace of the region from torch.profiler, and
`annotate` names a region inside it.  Both packages' trace() give the
same result of the region's code."""
import json
import os

import numpy as np


def test_trace_without_profiler():
    from bof_tpu.utils.profiling import trace as ref_trace
    from bof_tpu_torch.utils.profiling import trace
    with trace("region"):
        x = np.ones(10).sum()
    with ref_trace("region"):
        y = np.ones(10).sum()
    assert x == y == 10


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    import torch

    from bof_tpu_torch.utils.profiling import annotate, trace
    log_dir = str(tmp_path / "prof")
    with trace("gemm_region", log_dir):
        with annotate("inner_step"):
            z = (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert float(z) == 64 ** 3
    files = os.listdir(log_dir)
    assert files == [f"gemm_region.{os.getpid()}.trace.json"]
    with open(os.path.join(log_dir, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gemm_region", "inner_step"} <= names
