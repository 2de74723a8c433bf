"""gflops.unbounded: gflops (the work of the window's calls that passed over
the window, host clock) in the cells where the host's CPU sets its pace and
its runs spread too widely for the largest bound: recorded per layer there,
bounded only in the other cells."""
from oocbench.metrics.gflops import read  # noqa: F401
