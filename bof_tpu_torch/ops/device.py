"""Device-side steps of the out-of-core kernels, on torch.

The counterpart of `bof_tpu/ops/device.py` (reference: GemmTask::execute,
include/tasks/gemm_task.h:67-93 calls mkl_gemm on cached DRAM blocks):
each superblock accumulate step is one launch of kernel K1
(`matmul_cuda.accum_matmul`) on device-resident tiles, updating the C
accumulator in place — the K chain is ordered by the CUDA stream, as the
reference orders it with parent chains (gemm.cpp:114-126).

Blocks arrive in storage-major layout and K1 absorbs the transposes, so
no host or device transposition happens.  Every transfer here is
synchronous with respect to the host buffer it reads or fills: the
pipeline unpins a host tile right after `to_device` returns, so a copy
still in flight would read a recycled buffer.
"""
from __future__ import annotations

import numpy as np
import torch

from .matmul_cuda import accum_matmul


def resolve_device(name: str) -> torch.device:
    """The configured device (FlashConfig.device).  A CUDA device on a
    machine without a usable card raises; nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FlashConfig.device={name!r} but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private device copy of `x` (always a copy, also on the CPU: the
    source may be a pin-cache buffer that is recycled after this call)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, copy=True)


def from_device(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def sync(t: torch.Tensor) -> None:
    """Block until the work queued before this call on `t`'s device (on
    the calling thread's current stream) has finished."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def zeros_block(shape, device: torch.device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def scale_init(c: torch.Tensor, beta: float) -> torch.Tensor:
    """C-block initialization for beta != 0 (reference reads C and lets MKL
    apply beta, gemm_task.h:49-54; we scale once before the K loop), in
    place."""
    return c.mul_(beta)


def accum_step(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               alpha: float, *, a_km: bool, b_nk: bool, c_nm: bool,
               prec: str = "highest") -> torch.Tensor:
    """c += alpha * op(A) op(B), all in storage-major layout, in place.

    a: (bm,bk) if not a_km else (bk,bm)
    b: (bk,bn) if not b_nk else (bn,bk)
    c: (bm,bn) if not c_nm else (bn,bm)

    `prec` is accepted for every value bof_tpu accepts: K1 is full fp32
    FFMA, at least as precise as any of them (the faster TF32 passes for
    'high'/'default' are ROADMAP B1)."""
    if prec not in ("highest", "high", "default"):
        raise ValueError(f"unknown matmul precision {prec!r}")
    return accum_matmul(c, a, b, alpha, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
