"""host_peak_gib.csrmm: host_peak_gib in the csrmm cells, whose peak comes
from transients that differ by 1-2 % from run to run (the kernel's own
peak, ru_maxrss, rises in their windows), so they carry a bound of their
own instead of widening that of the other cells."""


def read(rec):
    return rec["host_peak_bytes"] / 2**30
