"""w_upload_share: the seconds xml_rank spent putting W's label panels on
the card (`xml_rank.w_h2d_s`: the upload from the pinned rows and the
transpose there) over the window's seconds, in %."""


def read(rec):
    secs = rec["counters"].get("xml_rank.w_h2d_s")
    if secs is None:
        return None
    return 100.0 * secs / rec["window_s"]
