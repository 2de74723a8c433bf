"""gram_k2_roofline: K2's share of the bound of the A^T A operator's two
sparse products, in %.  A call needs, whatever bands carry them, A's
nonzeros twice (a 4-byte column and a 4-byte value each, once a
product), V (k x b fp32) read once, W (m x b fp32) written once and read
once, and U (k x b) written once as K2's fp32 output; and 2 nnz b
operations a product.  The larger of bytes over 3.35 TB/s and operations
over 67 TFLOP/s, against the device seconds of every `spmm_ell_kernel`
launch of the window."""
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
    nbytes = (2 * 8.0 * s["nnz"] + 4.0 * s["k"] * s["n"]
              + 2 * 4.0 * s["m"] * s["n"] + 4.0 * s["k"] * s["n"])
    flops = 4.0 * s["nnz"] * s["n"]
    n = rec["attempted"]
    return 100.0 * peaks.bound_s(nbytes * n, flops * n,
                                 peaks.FP32_FLOPS) / secs
