"""bof_tpu_torch — out-of-core linear algebra on PyTorch and CUDA.

The port of `bof_tpu` (JAX/Pallas on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.  `bof_tpu` stays in the repository as the
frozen reference that every module here is tested against.  This package
imports torch and never jax.

What is ported so far:
- the out-of-core SGEMM slice: flash-resident dense arrays, the native
  O_DIRECT/AIO engine and pin cache, the task-DAG cache the pin cache sits
  on, and `gemm` with its 4-stage pipeline whose accumulate step is the
  CUDA kernel K1 (ops/matmul_cuda.py);
- the sparse slice: flash-resident CSR (`CsrFlashMatrix`), `csrmm` whose
  device block product is the CUDA ELL SpMM kernel K2, `csrgemv` on the
  CUDA ELL SpMV, and the host transpose `csrcsc` (sparse/);
- float64 gemm on K1's DMMA variant, also as `gemm64` (bof_tpu's name);
  tile-major files (`repack`, `unpack`); out-of-core k-means
  (`kmeans_fit`, `lloyds_iter`) whose Lloyd block step is the CUDA kernel
  pair B7 (ops/kmeans.py); and the dense and k-means CLI drivers;
- the paper's three applications (apps/): the block eigensolver
  (`block_lanczos_svd`, `block_power_svd`, both halves of their one-pass
  operator `apply_gram` on K2), extreme multi-label ranking (`xml_rank`: K2, then the
  CUDA row top-k B8, ops/topk_cuda.py) and topic modeling (`topic_model`
  on csrmm and k-means), with their CLI drivers;
- the data-processing primitives: the out-of-core sample sort `bof_sort`
  (its device block sorter the CUDA stable radix sort B10,
  ops/sort_cuda.py), `bof_map` (the caller's torch function on the
  card) and `bof_reduce`, the flash memory functions (`flash_memset`,
  `flash_memcpy`, `flash_truncate`) and multi-field sort keys
  (`lex_composite`), with the sort and map/reduce drivers.
ROADMAP.md lists what follows.
"""
from .config import DEFAULT_CONFIG, FlashConfig, config_from_reference
from .context import FlashContext, flash_destroy, flash_setup, get_context
from .core import (FlashArray, TiledFlashArray, flash_empty, flash_free,
                   map_array, map_tiled_array, mem_array)
from .core.tiled_array import repack, unpack
from .io import MemStore, StrideInfo
from .lib_funcs import flash_memcpy, flash_memset, flash_truncate
from .ops import bof_map, bof_reduce, bof_sort, gemm, gemm_in_mem
from .utils.lexkey import lex_composite
from .ops.gemm64 import gemm64
from .ops.kmeans import kmeans_fit, lloyds_iter
from .sparse import (CsrFlashMatrix, csrcsc, csrcsc_scratch, csrgemv,
                     csrmm)
from .apps import (apply_gram, block_lanczos_svd, block_power_svd,
                   topic_model, xml_rank)

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG", "FlashConfig", "config_from_reference",
    "FlashContext", "flash_destroy", "flash_setup", "get_context",
    "FlashArray", "TiledFlashArray", "flash_empty", "flash_free",
    "map_array", "map_tiled_array", "mem_array", "MemStore", "StrideInfo",
    "flash_memcpy", "flash_memset", "flash_truncate",
    "repack", "unpack", "bof_map", "bof_reduce", "bof_sort", "gemm",
    "gemm64", "gemm_in_mem", "lex_composite", "kmeans_fit",
    "lloyds_iter", "CsrFlashMatrix", "csrcsc", "csrcsc_scratch", "csrgemv",
    "csrmm",
    "apply_gram", "block_lanczos_svd", "block_power_svd", "topic_model",
    "xml_rank",
]
