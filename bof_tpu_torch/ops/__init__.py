from .gemm import gemm, gemm_in_mem

__all__ = ["gemm", "gemm_in_mem"]
