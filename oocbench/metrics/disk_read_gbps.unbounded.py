"""disk_read_gbps.unbounded: disk_read_gbps in the cells whose gflops is recorded per layer
(gflops.unbounded) and not bounded; the same reading."""
from oocbench.metrics.disk_read_gbps import read  # noqa: F401
