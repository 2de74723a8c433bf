"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit; the run records the card's `power.limit` beside
every number), and the least time a piece of work could take."""
from __future__ import annotations

HBM_BPS = 3.35e12       # device memory, bytes/s
TF32_FLOPS = 495e12     # TF32 tensor cores, FLOP/s
TF32X3_FLOPS = TF32_FLOPS / 3  # K1's 'highest' tier: three TF32 passes
FP32_FLOPS = 67e12      # fp32 outside the tensor cores, FLOP/s


def bound_s(nbytes: float, flops: float, flops_peak: float) -> float:
    """Bytes over the memory rate or operations over their peak, whichever
    is larger (seconds)."""
    return max(nbytes / HBM_BPS, flops / flops_peak)
