"""disk_read_gbps: the bytes the pin cache read from disk over the window
per second of the window, in GB/s.  The bytes are the window's misses
(`NativeTileCache.stats()`) times the bytes of a pin: the entry's
`pin_bytes` (gemm: a tile of A or B), else the mean over the lookups in
which each call pins its `pinned_bytes` once (csr: A's columns and
values a row block at a time), exact where a call's pins share one size
or all miss."""


def read(rec):
    pc = rec.get("pin_cache")
    if pc is None:
        return None
    return pc["miss_bytes"] / rec["window_s"] / 1e9
