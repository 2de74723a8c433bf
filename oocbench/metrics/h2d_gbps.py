"""h2d_gbps: bytes of the trace's `Memcpy HtoD` copies over their device
seconds, in GB/s."""


def read(rec):
    c = (rec.get("trace") or {}).get("copies", {}).get("HtoD")
    if not c or c[1] <= 0 or c[0] <= 0:
        return None
    return c[0] / c[1] / 1e9
