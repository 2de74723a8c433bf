"""Runtime configuration for bof_tpu_torch.

The same knobs as `bof_tpu.config.FlashConfig` (reference: CMakeLists.txt
:38-91 — N_IO_THR, N_COMPUTE_THR, PROGRAM_BUDGET, SECTOR_LEN,
GEMM_BLK_SIZE, ...), with the fields that only served the TPU dropped
(`device_compute`, `fp64_device`, `fp64_slices`, `gemm_tile`: on CUDA the
hand-written kernel is the only accumulate path) and one added: `device`,
the torch device the pipeline computes on.  It is explicit and never
auto-detected — asking for "cuda" on a machine without a card raises when
a kernel first needs the device, it does not run on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

SECTOR_LEN = 512  # SSD sector size; O_DIRECT alignment granularity


def _default_scratch() -> str:
    return os.environ.get("BOF_SCRATCH") or os.path.join(
        tempfile.gettempdir(), "bof_tpu_torch")


@dataclasses.dataclass
class FlashConfig:
    """All runtime knobs.  Defaults mirror the reference's CMake defaults
    where a direct analog exists (reference: CMakeLists.txt:38-91)."""

    # ---- I/O engine (reference: N_IO_THR, MAX_SIMUL_REQS, MAX_EVENTS) ----
    n_io_threads: int = 8
    max_simul_reqs: int = 64           # in-flight kernel-AIO iocbs (<=128)
    max_chunk_bytes: int = 32 << 20    # split requests larger than this
    use_o_direct: bool = False         # O_DIRECT on file stores
    io_backend: str = "auto"           # "native" | "python" | "auto"

    # ---- scheduler / cache (reference: N_COMPUTE_THR, PROGRAM_BUDGET) ----
    n_compute_threads: int = 4
    program_budget: int = 8 << 30      # host tile-cache budget in bytes
    enable_prioritizer: bool = True
    single_use_discard: bool = False
    max_in_mem_tasks_factor: int = 4   # max in-flight tasks = factor * n_compute
    tile_cache_backend: str = "auto"   # pin cache: "auto"|"native"|"python"

    # ---- device pipeline (no reference analog) ----
    device: str = "cuda"               # torch device: "cuda", "cuda:N", "cpu"
    hbm_budget: int = 12 << 30         # device-memory budget for tiles
    pipeline_depth: int = 3            # lookahead superblocks in flight
    transfer_dtype: str = "float32"    # "bfloat16" halves the host->device
    #   bytes of gemm's A/B tiles and of sparse ELL values (rounded to bf16
    #   on the host; accumulators and C stay fp32); "int8" quarters them
    #   (gemm: one max-abs scale a tile, int8 products summed exactly;
    #   sparse: one scale an ELL row).  fp32 operands only
    c_transfer_dtype: str = "float32"  # "bfloat16" halves the device->host
    #   bytes of gemm's C blocks and csrmm's results (rounded once on the
    #   device, widened exactly on the host; storage stays fp32)

    # ---- dense kernels (reference: GEMM_BLK_SIZE=8192) ----
    gemm_blk_size: int = 8192          # superblock edge for out-of-core gemm
    matmul_precision: str = "highest"  # K1 on the tensor cores: 3xTF32
    #   for "highest"/"high", one TF32 pass for "default"

    # ---- sparse kernels (reference: MAX_NNZS, CSRMM_*_CBLK_SIZE) ----
    # sparse_device_impl takes bof_tpu's values ("xla"|"pallas"|"auto");
    # every one runs kernel K2 on the card
    max_nnzs: int = 1 << 26
    csrmm_cblk_size: int = 4096
    csrgemv_blk_size: int = 1 << 20
    sparse_compute: str = "auto"
    sparse_device_impl: str = "auto"
    ell_sort_rows: bool = True
    ell_idx_narrow: bool = True

    # ---- lib funcs (reference: MAP_BLK_SIZE, REDUCE_BLK_SIZE, SORT) ----
    map_blk_elems: int = 1 << 24
    sort_blk_elems: int = 1 << 24
    sort_compute: str = "host"

    telemetry_sync: bool = False       # synchronize the device inside each
    #   timed transfer window so per-stage GB/s are transfer rates, not
    #   enqueue times; leave off in production

    # ---- debug self-checking (reference: DEBUG builds) ----
    debug_checks: bool = False

    # ---- misc ----
    scratch_dir: str = dataclasses.field(default_factory=_default_scratch)
    log_level: str = "info"

    def replace(self, **kw) -> "FlashConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = FlashConfig()

# bof_tpu fields with no meaning on CUDA (see the module docstring)
_TPU_ONLY = frozenset({"device_compute", "fp64_device", "fp64_slices",
                       "gemm_tile"})


def config_from_reference(d: dict, **overrides) -> FlashConfig:
    """The port's config for `dataclasses.asdict(bof_tpu.FlashConfig(...))`:
    every shared field carries over unchanged, the TPU-only fields are
    dropped, and `overrides` (e.g. device="cpu") apply last.  A field this
    config does not know raises, so the two cannot drift apart silently."""
    names = {f.name for f in dataclasses.fields(FlashConfig)}
    kw = {}
    for key, val in d.items():
        if key in _TPU_ONLY:
            continue
        if key not in names:
            raise KeyError(f"bof_tpu config field {key!r} has no "
                           "counterpart in bof_tpu_torch.FlashConfig")
        kw[key] = tuple(val) if isinstance(val, list) else val
    kw.update(overrides)
    return FlashConfig(**kw)
