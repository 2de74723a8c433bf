"""write_gbps: the rate of the entry's copies into C's store
(`<entry>.write_bytes` over `<entry>.write_s`, the writer's span over the
window's calls), in GB/s.  A program that books no bytes on the span
gives nothing to read."""


def read(rec):
    counters = rec["counters"]
    nbytes = counters.get(rec["entry"] + ".write_bytes")
    seconds = counters.get(rec["entry"] + ".write_s")
    if not nbytes or not seconds:
        return None
    return nbytes / seconds / 1e9
