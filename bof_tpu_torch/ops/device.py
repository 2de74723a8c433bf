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

import time

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


def to_device_bf16(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private bfloat16 device copy of bf16 values held as their np.uint16
    bits (io/native.py's `cast_bf16`); 2 bytes an element cross the link."""
    bits = np.ascontiguousarray(bits, np.uint16).view(np.int16)
    return to_device(bits, device).view(torch.bfloat16)


def from_device(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t`; a bfloat16 tensor comes back as its np.uint16
    bits (numpy has no bfloat16; io/native.py's `bf16_to_f32` widens
    them)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """Device-side cast for c_transfer_dtype='bfloat16' (bof_tpu's
    `to_bf16`): a finished C block rounds once (to nearest even) on the
    device, so half the bytes cross the link."""
    return t.to(torch.bfloat16)


def dtype_native_on_device(dt) -> bool:
    """True iff the port's device kernels compute in `dt` exactly.  The
    sparse kernels (K2, the SpMV) are fp32, so 64-bit values take the
    exact scipy host path instead of narrowing — as bof_tpu does on a TPU
    and on a CPU without x64 (an fp64 K2 is ROADMAP work)."""
    return np.dtype(dt).itemsize < 8


_link_gbps: dict = {}


def link_gbps_estimate(device: torch.device) -> float:
    """One-shot measured host->device rate (GB/s) for `device`, cached per
    device for the process: one 8 MiB incompressible upload, synchronized.
    Drives the sparse compute-placement heuristic ('auto').  A CPU device
    has no link to cross: infinite."""
    if device.type == "cpu":
        return float("inf")
    key = str(device)
    if key not in _link_gbps:
        x = np.random.default_rng(99).integers(0, 256, 8 << 20,
                                               dtype=np.uint8)
        sync(to_device(x[:1 << 16], device))  # warm the path
        t0 = time.perf_counter()
        sync(to_device(x, device))
        _link_gbps[key] = x.nbytes / max(time.perf_counter() - t0,
                                         1e-9) / 1e9
    return _link_gbps[key]


def sync(t: torch.Tensor) -> None:
    """Block until the work queued before this call on `t`'s device (on
    the calling thread's current stream) has finished."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def zeros_block(shape, device: torch.device,
                dtype=np.float32) -> torch.Tensor:
    """A fresh C accumulator (beta == 0), in C's numpy `dtype`."""
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    return torch.zeros(shape, dtype=tdt, device=device)


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

    `prec` takes bof_tpu's values, each at least as precise as the TPU's
    tier: 'highest' and 'high' run K1 as 3xTF32, 'default' as one TF32
    pass (`matmul_cuda.K1_PASSES`); an unknown value raises ValueError.
    bf16 tiles (transfer_dtype='bfloat16') run K1's 'bf16' variant at every
    `prec`, with the fp32 accumulator bof_tpu keeps for them; float64
    tiles run K1's 'f64' variant (DMMA) at every `prec`."""
    return accum_matmul(c, a, b, alpha, a_km=a_km, b_nk=b_nk, c_nm=c_nm,
                        prec=prec)


def accum_step_q(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: float, *, a_km: bool, b_nk: bool,
                 c_nm: bool) -> torch.Tensor:
    """The quantized step of transfer_dtype='int8' (bof_tpu's
    `accum_step_q`): a and b are int8 tiles (per-tile max-abs
    quantizations), their product is summed exactly in int32 and
    c += scale * f32(sum) with scale = alpha * s_a * s_b, in place: K1's
    's8' variant.  Input rounding is the only error."""
    return accum_matmul(c, a, b, scale, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
