"""setup_s: from the process's start to the window's start (host clock):
CUDA, the kernels' load (their build on a new checkout), the operands made
and written, the context and the warm-up call."""


def read(rec):
    return rec["setup_s"]
