"""spmv_roofline: the ELL SpMV's share of its bound, in %.  The bytes are
what the inputs need a call, whatever layout carries them: a 4-byte
column and a 4-byte value a nonzero, 4-byte row offsets, x and y once;
over 3.35 TB/s, against the device seconds of `spmv_ell_kernel`."""
from oocbench import peaks


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if "spmv_ell_kernel" in k)
    if secs <= 0:
        return None
    s = rec["shape"]
    nbytes = 8.0 * s["nnz"] + 4.0 * (s["m"] + 1) + 4.0 * s["k"] \
        + 4.0 * s["m"]
    return 100.0 * peaks.bound_s(nbytes * rec["attempted"], 0.0,
                                 peaks.FP32_FLOPS) / secs
