"""bof_tpu_torch — out-of-core linear algebra on PyTorch and CUDA.

The port of `bof_tpu` (JAX/Pallas on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.  `bof_tpu` stays in the repository as the
frozen reference that every module here is tested against.  This package
imports torch and never jax.

What is ported so far is the out-of-core SGEMM slice: flash-resident
dense arrays, the native O_DIRECT/AIO engine and pin cache, the task-DAG
cache the pin cache sits on, and `gemm` with its 4-stage pipeline whose
accumulate step is the CUDA kernel K1 (ops/matmul_cuda.py).  ROADMAP.md
lists what follows.
"""
from .config import DEFAULT_CONFIG, FlashConfig, config_from_reference
from .context import FlashContext, flash_destroy, flash_setup, get_context
from .core import (FlashArray, TiledFlashArray, flash_empty, flash_free,
                   map_array, map_tiled_array, mem_array)
from .io import MemStore, StrideInfo
from .ops import gemm, gemm_in_mem

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG", "FlashConfig", "config_from_reference",
    "FlashContext", "flash_destroy", "flash_setup", "get_context",
    "FlashArray", "TiledFlashArray", "flash_empty", "flash_free",
    "map_array", "map_tiled_array", "mem_array", "MemStore", "StrideInfo",
    "gemm", "gemm_in_mem",
]
