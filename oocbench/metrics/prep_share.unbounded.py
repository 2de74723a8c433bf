"""prep_share.unbounded: prep_share in the cells whose gflops is recorded per layer
(gflops.unbounded) and not bounded; the same reading."""
from oocbench.metrics.prep_share import read  # noqa: F401
