"""gflops: the work of the window's calls that passed over the window, from
its start to the end of its last call (host clock)."""


def read(rec):
    return rec["work_passed"] / rec["window_s"] / 1e9
