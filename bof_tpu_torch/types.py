"""Type and precision conventions (reference: include/bof_types.h).

bof_tpu's `types.py`, kept as the port's own copy.  The reference fixes
FBLAS_INT/FBLAS_UINT to 64-bit and selects FPTYPE (float or double) at
compile time (bof_types.h:14-42).  Here the element type travels with
each FlashArray and the device steps take it as they find it; these
constants and helpers document the conventions:

- indices (`IDX_DTYPE`): int64 on disk for format parity with the
  reference's 64-bit .off/.col files; the sparse kernels on the card
  gather with int32 (or uint16) indices (`IDX_DEVICE_DTYPE`) after
  nnz-budgeted blocking bounds block sizes.
- values (`FP_DTYPE`): float32 by default.  float64 runs natively on the
  card (K1's fp64 tensor-core variant), the analog of the reference's
  FP_DOUBLE_PRECISION build flag.
"""
from __future__ import annotations

import numpy as np

IDX_DTYPE = np.int64       # on-disk index type (FBLAS_UINT analog)
IDX_DEVICE_DTYPE = np.int32  # device-side gather indices
FP_DTYPE = np.float32      # default FPTYPE
OFFSET_DTYPE = np.int64    # CSR offsets

SUPPORTED_FP = (np.float32, np.float64)


def check_fp_dtype(dtype) -> np.dtype:
    dt = np.dtype(dtype)
    if dt.type not in SUPPORTED_FP:
        raise TypeError(f"unsupported value dtype {dt}; use one of "
                        f"{[np.dtype(t).name for t in SUPPORTED_FP]}")
    return dt
