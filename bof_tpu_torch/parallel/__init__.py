"""Several cards: the mesh, the sharded GEMM, csrmm and Lloyd steps (the
port of `bof_tpu/parallel/`, on torch.distributed)."""
from .csrmm_sp import csrmm_sharded, sharded_spmm_step
from .kmeans_dp import (dp_lloyd_step, kmeans_fit_sharded,
                        lloyds_iter_ooc_sharded, lloyds_iter_sharded)
from .mesh import gemm_sharded, make_mesh, sharded_accum_step, sharding_for

__all__ = ["csrmm_sharded", "sharded_spmm_step", "dp_lloyd_step",
           "kmeans_fit_sharded", "lloyds_iter_ooc_sharded",
           "lloyds_iter_sharded", "gemm_sharded", "make_mesh",
           "sharded_accum_step", "sharding_for"]
