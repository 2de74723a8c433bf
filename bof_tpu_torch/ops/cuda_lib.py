"""The port's one CUDA kernel library: build, load and bind.

Every `bof_tpu_torch/csrc/*.cu` is compiled at first use, one nvcc
process per source, all started together, and the objects are linked
into `build/bof_tpu_torch/kernels/libbof_kernels-<digest>.so` (route (b):
plain C entry points loaded with ctypes, no PyTorch headers), keyed by a
digest of the flags and of every `csrc/*.cu` and `*.cuh`, and serialized
by a flock.  Nothing is linked beyond nvcc's defaults: the TMA tensor
maps' encoder is fetched from the driver at run time.  A failed
build raises.  The kernel wrappers (`ops/matmul_cuda.py`, `ops/kmeans.py`,
`ops/topk_cuda.py`, `ops/sort_cuda.py`, `sparse/spmm_cuda.py`) take their
entry points from `build()`.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from ..io.native import build_root
from ..utils import LOG

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P, _I, _LL, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_double
# entry point -> argtypes (every one returns cudaGetLastError() as an int,
# but those of _SIZES)
_ENTRIES = {
    "bof_accum_matmul_tf32": [_P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
                              _LL, _LL, _LL, _I, _P, _P, _P, _P, _LL, _P],
    "bof_accum_matmul_lowp": [_P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
                              _LL, _LL, _LL, _I, _P, _P, _LL, _P],
    "bof_accum_matmul_s8_i32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _LL,
                                _LL, _LL, _P, _P, _LL, _P],
    "bof_accum_matmul_f64": [_P, _P, _P, _D, _I, _I, _I, _I, _I, _I,
                             _LL, _LL, _LL, _P],
    "bof_lloyd_assign": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                         _I, _P],
    "bof_lloyd_accumulate": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "bof_lloyd_accumulate_scratch_ints": [_I, _I],
    "bof_spmm_ell": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _F, _LL, _LL, _LL,
                     _I, _P],
    "bof_spmv_ell": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _F, _LL, _LL, _I,
                     _P],
    "bof_row_topk": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "bof_sort_block": [_P, _P, _P, _P, _LL, _I, _P],
    "bof_sort_block_scratch_ints": [_LL],
}
# return a size, long long
_SIZES = {"bof_lloyd_accumulate_scratch_ints", "bof_sort_block_scratch_ints"}

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}  # filled by the first build: path, seconds, ptxas log


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of bof_tpu_torch cannot be built")


def _digest(files) -> str:
    """Of the flags and every source and header, so that any change to
    what the compiler reads rebuilds."""
    import hashlib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise with the output of the first
    that fails, else return all their output."""
    LOG.info("building CUDA kernels: %s", " ; ".join(" ".join(c)
                                                    for c in cmds))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                               f"{cmd[-1]}:\n{out}")
    return "".join(outs)


def _compile_and_link(sources, so: str) -> str:
    """One nvcc -c per source, all at once, then one link; returns the
    compilers' output (ptxas -v reports registers and spills)."""
    nvcc = _nvcc()
    tmp = f"{so}.tmp.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for obj, src in zip(objs, sources)])
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.unlink(path)
    return log


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        import fcntl
        sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
        headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
        out_dir = os.path.join(build_root(), "kernels")
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir,
                          f"libbof_kernels-{_digest(sources + headers)}.so")
        t0 = time.perf_counter()
        log = ""
        with open(so + ".lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if not os.path.exists(so):
                    log = _compile_and_link(sources, so)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
        lib = ctypes.CDLL(so)
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _LL if name in _SIZES else ctypes.c_int
        BUILD_INFO.update(path=so, seconds=time.perf_counter() - t0,
                          ptxas=log)
        _lib = lib
        return _lib
