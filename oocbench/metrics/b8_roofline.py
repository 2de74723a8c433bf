"""b8_roofline: B8's (the row top-k's) share of its bound, in %.  A label
panel reads a band's scores once (rows x panel fp32) and writes k scores
and k labels a row (8 bytes each pair); a call takes every panel of W
over every row of its quarter.  The bytes over 3.35 TB/s, against the
device seconds of `row_topk_kernel` and `row_topk_reg_kernel`."""
from oocbench import peaks

KERNELS = ("row_topk_kernel", "row_topk_reg_kernel")


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if k.startswith(KERNELS))
    if secs <= 0:
        return None
    s = rec["shape"]
    lb = s["label_blk"]
    panels = -(-s["n"] // lb)
    nbytes = s["m"] * panels * (4.0 * lb + 8.0 * s["top_k"])
    return 100.0 * peaks.bound_s(nbytes * rec["attempted"], 0.0,
                                 peaks.FP32_FLOPS) / secs
