"""Kernel K2 (ELL SpMM) and the ELL SpMV, on torch.

The counterpart of `bof_tpu/sparse/spmm_pallas.py`.  `spmm_ell` launches
the hand-written CUDA kernel `bof_spmm_ell_f32` (`csrc/spmm_ell.cu`,
replacing `spmm_pallas.py:spmm_ell_pallas` and its XLA twin
`spmm_device.py:ell_gather_reduce`); `spmv_ell` launches
`bof_spmv_ell_f32` (replacing the XLA step `spmm_device.py:
spmv_ell_block`).  On CPU tensors each runs its plain PyTorch version
(`spmm_ell_ref`, `spmv_ell_ref`); on a CUDA tensor it launches the kernel
or raises.  Each wrapper counts its launches in `.launches`.

The Pallas kernel's eligibility gates (`pallas_feasible`,
`pallas_eligible`) exist only for the v5e's VMEM and are not ported: the
CUDA kernel takes any panel height, any cb and any rmax.
"""
from __future__ import annotations

import torch

from ..ops.cuda_lib import build

_IDX_TYPES = (torch.int32, torch.uint16)


def _check(name, dense, ja_ell, va_ell, dense_dim):
    if ja_ell.dim() != 2 or va_ell.shape != ja_ell.shape:
        raise ValueError(f"{name}: ja {tuple(ja_ell.shape)} and va "
                         f"{tuple(va_ell.shape)} must be one (rows, rmax) "
                         "shape")
    if dense.dim() != dense_dim:
        raise ValueError(f"{name}: dense operand must be {dense_dim}-D, got "
                         f"{tuple(dense.shape)}")
    if dense.dtype != torch.float32 or va_ell.dtype != torch.float32:
        raise TypeError(f"{name} is fp32 only (dense {dense.dtype}, va "
                        f"{va_ell.dtype})")
    if ja_ell.dtype not in _IDX_TYPES:
        raise TypeError(f"{name}: ja must be int32 or uint16, got "
                        f"{ja_ell.dtype}")
    devs = {dense.device, ja_ell.device, va_ell.device}
    if len(devs) != 1:
        raise ValueError(f"{name} operands on several devices: {devs}")
    if not (dense.is_contiguous() and ja_ell.is_contiguous()
            and va_ell.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    dev = dense.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if ja_ell.shape[0] > 2 ** 31 - 1:
        raise ValueError(f"{name}: {ja_ell.shape[0]} rows exceed one grid")
    return dev


def _launch(fn, dev, *args):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def spmm_ell_ref(b_panel: torch.Tensor, ja_ell: torch.Tensor,
                 va_ell: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (rows, cb) = sum_s va[:, s] * B[ja[:, s]]
    (fp32; the gather materializes rows * rmax * cb values)."""
    return (va_ell[:, :, None] * b_panel[ja_ell.to(torch.int64)]).sum(1)


def spmm_ell(b_panel: torch.Tensor, ja_ell: torch.Tensor,
             va_ell: torch.Tensor) -> torch.Tensor:
    """out[r, :] = sum_s va_ell[r, s] * b_panel[ja_ell[r, s], :].

    b_panel: (k, cb) fp32; ja_ell: (rows, rmax) int32 or uint16 with
    entries in [0, k); va_ell: (rows, rmax) fp32, padding slots 0.  Any
    cb and rmax.  Returns a new (rows, cb) fp32 tensor; CUDA tensors
    launch K2 on the current stream, CPU tensors take the plain version."""
    dev = _check("spmm_ell", b_panel, ja_ell, va_ell, 2)
    if dev.type == "cpu":
        return spmm_ell_ref(b_panel, ja_ell, va_ell)
    rows, rmax = ja_ell.shape
    cb = b_panel.shape[1]
    out = torch.empty((rows, cb), dtype=torch.float32, device=dev)
    vec4 = (cb % 4 == 0 and b_panel.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    _launch(build().bof_spmm_ell_f32, dev, out.data_ptr(),
            b_panel.data_ptr(), ja_ell.data_ptr(),
            int(ja_ell.dtype == torch.uint16), va_ell.data_ptr(), rows, rmax,
            cb, int(vec4))
    spmm_ell.launches += 1
    return out


spmm_ell.launches = 0


def spmv_ell_ref(x: torch.Tensor, ja_ell: torch.Tensor,
                 va_ell: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the SpMV: y[r] = sum_s va[r, s] * x[ja[r, s]]."""
    return (va_ell * x[ja_ell.to(torch.int64)]).sum(1)


def spmv_ell(x: torch.Tensor, ja_ell: torch.Tensor,
             va_ell: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_s va_ell[r, s] * x[ja_ell[r, s]] (csrgemv 'N').

    x: (k,) fp32; ja_ell/va_ell as for `spmm_ell`.  Returns a new (rows,)
    fp32 tensor; CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    dev = _check("spmv_ell", x, ja_ell, va_ell, 1)
    if dev.type == "cpu":
        return spmv_ell_ref(x, ja_ell, va_ell)
    rows, rmax = ja_ell.shape
    y = torch.empty((rows,), dtype=torch.float32, device=dev)
    _launch(build().bof_spmv_ell_f32, dev, y.data_ptr(), x.data_ptr(),
            ja_ell.data_ptr(), int(ja_ell.dtype == torch.uint16),
            va_ell.data_ptr(), rows, rmax)
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
