"""pin_hit_ratio.unbounded: pin_hit_ratio in the cells whose gflops is recorded per layer
(gflops.unbounded) and not bounded; the same reading."""
from oocbench.metrics.pin_hit_ratio import read  # noqa: F401
