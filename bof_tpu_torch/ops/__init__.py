from .gemm import gemm, gemm_in_mem
from .map_reduce import bof_map, bof_reduce
from .sort import bof_sort

__all__ = ["gemm", "gemm_in_mem", "bof_map", "bof_reduce", "bof_sort"]
