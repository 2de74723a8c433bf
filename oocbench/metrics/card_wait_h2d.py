"""card_wait_h2d: the card's idle seconds in the traced window that the
booking rule (oocbench/spans.py:book) gives to a `*.h2d` span of the
port, over the window's seconds, in % (layer: H2D)."""
from oocbench.metrics._card_wait import share


def read(rec):
    return share(rec, ".h2d")
