"""band_reuse_share: the share of xml_rank's band launches served from
bands kept from an earlier label panel of the call, in %:
`xml_rank.bands_reused` over it plus `xml_rank.bands_built` (bands formed
from a row block).  A program that does not count its bands gives
nothing to read."""


def read(rec):
    built = rec["counters"].get("xml_rank.bands_built", 0.0)
    reused = rec["counters"].get("xml_rank.bands_reused", 0.0)
    if not built + reused:
        return None
    return 100.0 * reused / (built + reused)
