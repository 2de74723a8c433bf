"""h2d_locked_share: the share of the window's uploaded bytes whose host
source was page-locked (`h2d.locked_bytes` over `h2d.bytes`, counted by
the program's `to_device`), in %.  A program that does not count its
uploads gives nothing to read."""


def read(rec):
    total = rec["counters"].get("h2d.bytes")
    if not total:
        return None
    return 100.0 * rec["counters"].get("h2d.locked_bytes", 0.0) / total
