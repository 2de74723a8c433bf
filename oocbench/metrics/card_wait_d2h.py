"""card_wait_d2h: the card's idle seconds in the traced window that the
booking rule (oocbench/spans.py:book) gives to a `*.d2h` span of the
port, over the window's seconds, in % (layer: D2H)."""
from oocbench.metrics._card_wait import share


def read(rec):
    return share(rec, ".d2h")
