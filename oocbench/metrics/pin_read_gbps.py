"""pin_read_gbps: the bytes the native pin cache read from disk in the
window (the change of `FlashContext.pin_cache_stats()["read_bytes"]`,
counted by the cache on every pin that missed) over the window's
seconds, in GB/s."""


def read(rec):
    nbytes = rec.get("pin_read_bytes")
    if nbytes is None:
        return None
    return nbytes / rec["window_s"] / 1e9
