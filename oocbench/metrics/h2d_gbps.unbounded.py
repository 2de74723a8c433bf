"""h2d_gbps.unbounded: h2d_gbps in the cells whose gflops is recorded per layer
(gflops.unbounded) and not bounded; the same reading."""
from oocbench.metrics.h2d_gbps import read  # noqa: F401
