"""prep_share: the program's host-prep seconds (`<entry>.prep_s`, summed
over its threads) over the window's seconds, in %.  Stages overlap, so
this is a share of the window and adds to no other."""


def read(rec):
    key = rec["entry"] + ".prep_s"
    if key not in rec["counters"]:
        return None
    return 100.0 * rec["counters"][key] / rec["window_s"]
