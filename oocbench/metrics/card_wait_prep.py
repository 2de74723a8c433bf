"""card_wait_prep: the card's idle seconds in the traced window that the
booking rule (oocbench/spans.py:book) gives to a `*.prep` span of the
port, over the window's seconds, in % (layer: host prep)."""
from oocbench.metrics._card_wait import share


def read(rec):
    return share(rec, ".prep")
