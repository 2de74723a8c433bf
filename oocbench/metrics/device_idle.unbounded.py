"""device_idle.unbounded: device_idle in the cells whose gflops is recorded per layer
(gflops.unbounded) and not bounded; the same reading."""
from oocbench.metrics.device_idle import read  # noqa: F401
