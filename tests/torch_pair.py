"""The two packages side by side, for the port's differential tests of the
shared layers (tests/test_torch_{utils,io,native_cache,scheduler,cache,
flash_array,tiled,edge_cases,fuzz}.py).

A test runs one body on `REF` (bof_tpu) and on `PORT` (bof_tpu_torch) with
the same numpy inputs and compares what the two give.  `Pkg.mod("a.b")`
imports `<package>.a.b`; `Pkg.context` opens a FlashContext of the
package's own (the port's on the CPU).  `port_engine()` is the port's
native I/O engine, built from bof_tpu_torch/native/: a test that needs it
fails when it does not load, where the library itself would quietly fall
back to Python I/O.
"""
from __future__ import annotations

import importlib
import os


class Pkg:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name

    @property
    def bt(self):
        return importlib.import_module(self.name)

    @property
    def is_port(self) -> bool:
        return self.name == "bof_tpu_torch"

    def mod(self, sub: str):
        return importlib.import_module(f"{self.name}.{sub}")

    def config(self, **kw):
        if self.is_port:
            kw.setdefault("device", "cpu")
        return self.bt.FlashConfig(**kw)

    def context(self, scratch, **kw):
        """A FlashContext with the reference tests' `ctx` settings unless
        `kw` says otherwise (4 I/O threads, 2 compute threads, a 256 MiB
        program budget)."""
        kw.setdefault("n_io_threads", 4)
        kw.setdefault("n_compute_threads", 2)
        kw.setdefault("program_budget", 256 << 20)
        return self.bt.FlashContext(self.config(scratch_dir=str(scratch),
                                                **kw))


REF = Pkg("bof_tpu")
PORT = Pkg("bof_tpu_torch")
BOTH = (REF, PORT)


def engine(pkg: Pkg):
    """The package's native I/O engine, which must load: the port's is
    built from its own sources under `build_root()`."""
    native = pkg.mod("io.native")
    lib = native.load_library()
    assert lib is not None, f"{pkg}'s native I/O engine did not load"
    if pkg.is_port:
        assert lib._name.startswith(native.build_root() + os.sep), lib._name
    return lib


def port_engine():
    return engine(PORT)


def run_both(body, *args, **kw):
    """(body(REF, ...), body(PORT, ...))."""
    return body(REF, *args, **kw), body(PORT, *args, **kw)
