"""The cell sgemm_fig5.int8 at a tiny size on the CPU (the port's plain
kernels; the host quantization is the card's): a run is correct under
the mix's limit, and `correct` comes out false under the mix's planted
control (int4's codes, `oocbench.planted`) and under planted faults (a
tile's int8 scale off by 2, a dropped K step).  The port has no mode
below int8 on the link, so the control is planted in-process."""
import copy
import json
import os

import numpy as np
import pytest

from oocbench import planted
from oocbench import run as R
from oocbench.tests.tiny import DENSE


def _run(seed=2**31 + 55):
    with open(os.path.join(R.HERE, "mixes", "int8.json")) as f:
        mix = json.load(f)
    mix["flash_config"] = dict(mix["flash_config"], gemm_blk_size=256)
    rec = R.run(copy.deepcopy(DENSE), mix, seed, 0.5, False, device="cpu",
                log=lambda s: None)
    return rec, R.result_line(rec, [], {"platform": "cpu"}, False)


def test_a_tiny_int8_run_is_correct():
    rec, line = _run()
    assert line["correct"] is True, rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    # int8 rounding, far inside the limit and far above fp32's
    assert 1e-4 < rec["checks"]["rel_err"]["value"] < \
        rec["checks"]["rel_err"]["limit"] / 2


def test_the_stand_in_at_8_bits_is_the_port_quantizer():
    """The planted quantizer changes only the grid: at 8 bits it gives
    the port's codes and scale bit for bit."""
    from bof_tpu_torch.io.native import quantize_i8_numpy
    x = np.random.default_rng(3).standard_normal((64, 96)).astype(np.float32)
    x[5, 7] = 0.5 + 2.0 ** -20  # near a half step: the rounding's tie rule
    q, scale = planted.coarse_quantizer(8)(x)
    want_q, want_scale = quantize_i8_numpy(x)
    np.testing.assert_array_equal(q, want_q)
    assert scale == want_scale


@pytest.mark.parametrize("kind", ["scale_x2", "dropped_k_step", "int4"])
def test_a_broken_int8_path_is_not_correct(kind):
    with open(os.path.join(R.HERE, "mixes", "int8.json")) as f:
        assert json.load(f)["control"]["planted"] == "int4"
    with planted.planted(kind):
        rec, line = _run()
    assert rec["attempted"] >= 1
    assert line["correct"] is False, rec["checks"]
