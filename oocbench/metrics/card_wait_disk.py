"""card_wait_disk: the card's idle seconds in the traced window that the
booking rule (oocbench/spans.py:book) gives to a `*.disk_wait` span of the
port, over the window's seconds, in % (layer: disk to pin cache)."""
from oocbench.metrics._card_wait import share


def read(rec):
    return share(rec, ".disk_wait")
