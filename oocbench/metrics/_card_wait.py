"""The share of the traced window in which the card idled waiting on one
kind of program span (oocbench/spans.py): the card_wait_* readers."""


def share(rec, suffix: str):
    t = rec.get("trace") or {}
    booked = t.get("idle_booked")
    if booked is None or not t.get("window_s"):
        return None
    return 100.0 * sum(v for k, v in booked.items()
                       if k.endswith(suffix)) / t["window_s"]
