"""host_peak_gib: the process's peak resident memory over the window: the
kernel's peak (ru_maxrss) where it rose in the window, else the largest
/proc/self/statm reading a thread of the harness took every 250 ms."""


def read(rec):
    return rec["host_peak_bytes"] / 2**30
