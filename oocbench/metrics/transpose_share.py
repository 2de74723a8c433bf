"""transpose_share: the eigensolver's band pool transposing its bands, in
% of the window: `eig.transpose_s` (each band's CSC over the words it
touches, their plan and their ELL bands; seconds summed over the pool's
threads) over the pool's threads a call (`eig.band_threads` over
`eig.op_applies`) and the window's seconds.  Stages overlap, so this is
a share of the window and adds to no other.  A program that does not time
the stage or count its threads gives nothing to read."""


def pool_share(rec, key):
    """100 x counter `key` (thread seconds on the eigensolver's band pool)
    / (the pool's threads a call x the window), or None."""
    c = rec["counters"]
    if key not in c or not c.get("eig.band_threads") \
            or not c.get("eig.op_applies"):
        return None
    threads = c["eig.band_threads"] / c["eig.op_applies"]
    return 100.0 * c[key] / threads / rec["window_s"]


def read(rec):
    return pool_share(rec, "eig.transpose_s")
