"""k1_roofline: K1's share of its bound, in %.  The work is what the
inputs need, 2 m n k a call, at the 3xTF32 tier's peak (495 / 3 TFLOP/s,
the data sheet's TF32 rate over K1's three passes), over the device
seconds of K1's kernels (the split pass and the product) in the trace."""
from oocbench import peaks

KERNELS = ("accum_tf32_kernel", "tf32_split_kernel")


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if any(n in k for n in KERNELS))
    if secs <= 0:
        return None
    s = rec["shape"]
    flops = 2.0 * s["m"] * s["n"] * s["k"] * rec["attempted"]
    return 100.0 * peaks.bound_s(0.0, flops, peaks.TF32X3_FLOPS) / secs
