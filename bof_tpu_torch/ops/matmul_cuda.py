"""Kernel K1: the superblock accumulate step `C += alpha * op(A) op(B)`.

`accum_matmul` launches the hand-written CUDA kernel in
`bof_tpu_torch/csrc/matmul.cu` (replacing `bof_tpu/ops/matmul_pallas.py:
matmul` plus `bof_tpu/ops/device.py:accum_step`'s epilogue) on CUDA
tensors, and runs its plain PyTorch version, `accum_matmul_ref`, on CPU
tensors.  Nothing else chooses between the two: a CUDA tensor launches the
kernel or raises.

The kernel is built at first use with the port's other kernels into one
library (`ops/cuda_lib.py`).
"""
from __future__ import annotations

import torch

from .cuda_lib import build


def _logical_dims(c, a, b, a_km, b_nk, c_nm):
    if a.dim() != 2 or b.dim() != 2 or c.dim() != 2:
        raise ValueError("accum_matmul takes 2-D tensors")
    m, k = (a.shape[1], a.shape[0]) if a_km else a.shape
    k2, n = (b.shape[1], b.shape[0]) if b_nk else b.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: a {tuple(a.shape)} "
                         f"(a_km={a_km}) vs b {tuple(b.shape)} (b_nk={b_nk})")
    want_c = (n, m) if c_nm else (m, n)
    if tuple(c.shape) != want_c:
        raise ValueError(f"c is {tuple(c.shape)}, expected {want_c} "
                         f"(c_nm={c_nm})")
    return m, n, k


def accum_matmul_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     alpha: float, *, a_km: bool, b_nk: bool,
                     c_nm: bool) -> torch.Tensor:
    """Plain PyTorch version of K1: c += alpha * op(a) @ op(b) in c's
    storage layout, in place; returns c."""
    _logical_dims(c, a, b, a_km, b_nk, c_nm)
    out = (a.T if a_km else a) @ (b.T if b_nk else b)
    return c.add_(out.T if c_nm else out, alpha=float(alpha))


def accum_matmul(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 alpha: float, *, a_km: bool, b_nk: bool,
                 c_nm: bool) -> torch.Tensor:
    """c += alpha * op(a) @ op(b), in place, all in storage-major layout:
    a is (M,K) or (K,M) with a_km; b is (K,N) or (N,K) with b_nk; c is
    (M,N) or (N,M) with c_nm.  fp32, contiguous, one device.  CUDA tensors
    launch K1 on the current stream; CPU tensors take the plain version."""
    m, n, k = _logical_dims(c, a, b, a_km, b_nk, c_nm)
    devs = {c.device, a.device, b.device}
    if len(devs) != 1:
        raise ValueError(f"accum_matmul operands on several devices: {devs}")
    if c.dtype != torch.float32 or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise TypeError(f"accum_matmul is fp32 only (c {c.dtype}, "
                        f"a {a.dtype}, b {b.dtype})")
    if not (c.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("accum_matmul needs contiguous tensors")
    dev = c.device
    if dev.type == "cpu":
        return accum_matmul_ref(c, a, b, alpha, a_km=a_km, b_nk=b_nk,
                                c_nm=c_nm)
    if dev.type != "cuda":
        raise ValueError(f"accum_matmul: unsupported device {dev}")
    if min(m, n, k) == 0:
        return c  # nothing to add; the C entry would launch nothing
    fn = build().bof_accum_matmul_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha),
                m, n, k, int(a_km), int(b_nk), int(c_nm),
                a.shape[1], b.shape[1], c.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"bof_accum_matmul_f32 launch failed: CUDA error "
                           f"{rc}")
    accum_matmul.launches += 1
    return c


accum_matmul.launches = 0
