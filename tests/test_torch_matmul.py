"""Kernel K1 (bof_tpu_torch/ops/matmul_cuda.py) and the port's device
step, held against bof_tpu's Pallas MXU kernel (interpret mode) and its
XLA accumulate step on the same numpy inputs.

fp32 tolerance rtol 2e-4 (accumulation order differs between XLA, the
Pallas interpreter and torch; the repo's invariant).  The kernel itself
runs only on a CUDA card: tests/test_torch_cuda.py holds it against this
plain version there.
"""
import itertools

import numpy as np
import pytest
import torch

from bof_tpu.ops import device as ref_device
from bof_tpu.ops.matmul_pallas import matmul as pallas_matmul
from bof_tpu_torch.ops import device as port_device
from bof_tpu_torch.ops.matmul_cuda import accum_matmul, accum_matmul_ref

LAYOUTS = list(itertools.product([False, True], repeat=3))


def _storage(rng, m, n, k, a_km, b_nk, c_nm):
    """Storage-major operands of one logical problem (numpy, fp32)."""
    a_log = rng.standard_normal((m, k)).astype(np.float32)
    b_log = rng.standard_normal((k, n)).astype(np.float32)
    c_log = rng.standard_normal((m, n)).astype(np.float32)
    a = np.ascontiguousarray(a_log.T) if a_km else a_log
    b = np.ascontiguousarray(b_log.T) if b_nk else b_log
    c = np.ascontiguousarray(c_log.T) if c_nm else c_log
    return a, b, c


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_plain_version_matches_pallas_interpret(rng, a_km, b_nk, c_nm):
    """accum_matmul_ref on a zero C is the Pallas kernel's product, for
    every storage layout (tests/test_pallas.py's shapes and tiles)."""
    m, n, k = 256, 128, 128
    a, b, _ = _storage(rng, m, n, k, a_km, b_nk, c_nm)
    want = np.asarray(pallas_matmul(a, b, bm=128, bn=128, bk=64,
                                    a_km=a_km, b_nk=b_nk, c_nm=c_nm,
                                    interpret=True))
    c = torch.zeros((n, m) if c_nm else (m, n))
    got = accum_matmul_ref(c, torch.from_numpy(a), torch.from_numpy(b), 1.0,
                           a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_accum_step_matches_reference(rng, a_km, b_nk, c_nm):
    """The port's device.accum_step against bof_tpu's XLA accumulate
    step: alpha != 1, a non-zero C, a ragged shape, updated in place."""
    m, n, k = 40, 24, 56
    alpha = 1.75
    a, b, c = _storage(rng, m, n, k, a_km, b_nk, c_nm)
    want = np.asarray(ref_device.accum_step(
        c.copy(), a, b, np.float32(alpha), a_km=a_km, b_nk=b_nk, c_nm=c_nm,
        prec="highest", impl="xla"))
    c_t = torch.from_numpy(c.copy())
    got = port_device.accum_step(c_t, torch.from_numpy(a),
                                 torch.from_numpy(b), alpha, a_km=a_km,
                                 b_nk=b_nk, c_nm=c_nm, prec="highest")
    assert got.data_ptr() == c_t.data_ptr(), "accum_step updates C in place"
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "inner"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(4, 6)
    b = torch.zeros(6, 5)
    c = torch.zeros(4, 5)
    if bad == "dtype":
        a, err = a.double(), TypeError
    elif bad == "shape":
        c, err = torch.zeros(5, 4), ValueError
    elif bad == "contiguity":
        a, err = torch.zeros(6, 4).T, ValueError
    else:
        b, err = torch.zeros(7, 5), ValueError
    with pytest.raises(err):
        accum_matmul(c, a, b, 1.0, a_km=False, b_nk=False, c_nm=False)


def test_scale_init_and_zeros_block():
    c = torch.ones(3, 4)
    assert port_device.scale_init(c, 2.5) is c
    assert float(c.sum()) == 30.0
    z = port_device.zeros_block((2, 3), torch.device("cpu"))
    assert z.dtype == torch.float32 and not z.any()
