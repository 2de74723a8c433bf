"""d2h_gbps.unbounded: d2h_gbps in the cells whose gflops is recorded per layer
(gflops.unbounded) and not bounded; the same reading."""
from oocbench.metrics.d2h_gbps import read  # noqa: F401
