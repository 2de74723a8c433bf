"""k1_s8_roofline: K1 's8''s share of its bound, in %.  The work is what
the inputs need, 2 m n k a call, at the int8 tensor cores' peak (1,979
TOPS, the data sheet's dense rate), over the device seconds of the 's8'
product (`accum_lowp_kernel<1, ...>`) and its pack pass (`pack_kernel` on
the int8 bytes, `unsigned char`, which writes the K-major copy of an
operand) in the trace."""
from oocbench import peaks

INT8_OPS = 1979e12   # int8 tensor cores, dense, operations/s
KERNELS = ("accum_lowp_kernel<1,", "pack_kernel<unsigned char,")


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if k.startswith(KERNELS))
    if secs <= 0:
        return None
    s = rec["shape"]
    ops = 2.0 * s["m"] * s["n"] * s["k"] * rec["attempted"]
    return 100.0 * peaks.bound_s(0.0, ops, INT8_OPS) / secs
