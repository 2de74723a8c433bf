"""device_peak_gib: torch.cuda.max_memory_allocated over the window (the
peak statistics reset at its start)."""


def read(rec):
    return rec["device_peak_bytes"] / 2**30
