"""pin_hit_ratio: pin-cache hits over lookups in the window
(NativeTileCache.stats(), the change over the window), in %."""


def read(rec):
    pc = rec.get("pin_cache")
    if not pc or pc["hits"] + pc["misses"] <= 0:
        return None
    return 100.0 * pc["hits"] / (pc["hits"] + pc["misses"])
