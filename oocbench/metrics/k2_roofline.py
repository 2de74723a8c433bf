"""k2_roofline: K2's (the ELL SpMM's) share of its bound, in %.  A call
needs a 4-byte column and a 4-byte value a nonzero, 4-byte row offsets,
B (k x n) and C (m x n) once, and 2 nnz n fp32 operations; the bound is
the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s,
against the device seconds of `spmm_ell_kernel`."""
from oocbench import peaks


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if "spmm_ell_kernel" in k)
    if secs <= 0:
        return None
    s = rec["shape"]
    nbytes = (8.0 * s["nnz"] + 4.0 * (s["m"] + 1) + 4.0 * s["k"] * s["n"]
              + 4.0 * s["m"] * s["n"])
    flops = 2.0 * s["nnz"] * s["n"]
    n = rec["attempted"]
    return 100.0 * peaks.bound_s(nbytes * n, flops * n,
                                 peaks.FP32_FLOPS) / secs
