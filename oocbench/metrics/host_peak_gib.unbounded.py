"""host_peak_gib.unbounded: host_peak_gib in the cells whose Program Cache
is sized to hold their largest operand (the xml cell's W), so that the
peak is the budget's choice more than the program's: recorded per layer
there, where the transients outside the cache (bands, staging, the merge)
still show, and bounded only in the other cells."""
from oocbench.metrics.host_peak_gib import read  # noqa: F401
