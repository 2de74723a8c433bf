"""prep_share.eig: prep_share in the eigensolver's cell, where the forward
banding runs on a pool of threads: `eig.prep_s` (thread seconds) over
the pool's threads a call and the window's seconds, in %, so that it
reads as a share of the window as prep_share does where one thread
prepares.  Nothing to read where the program does not count the pool's
threads."""
from oocbench.metrics.transpose_share import pool_share


def read(rec):
    return pool_share(rec, "eig.prep_s")
