// K1 variant 'f64': C_storage += alpha * op(A) op(B), all float64, on Hopper's
// fp64 tensor cores (DMMA, mma.sync.aligned.m8n8k4.f64).
//
// Replaces bof_tpu/ops/gemm64.py:89 _slice_accum and :178 _renorm_digits (the
// Ozaki emulation: a TPU has no fp64 unit, so bof_tpu splits each fp64 tile
// into int8 mantissa slices and sums their exact int8 products in int32
// planes) and, on a backend with fp64, bof_tpu/ops/device.py:90 accum_step in
// x64.  Hopper multiplies fp64 directly, so there are no slices, no planes and
// no host fold: each superblock step reads A and B once, keeps the partial
// product in registers and updates C in place, as K1's fp32 variants do.
//
// Layouts are K1's, in storage-major order:
//   A is (M,K) row-major, or (K,M) with a_km;
//   B is (K,N) row-major, or (N,K) with b_nk;
//   C is (M,N) row-major, or (N,M) with c_nm.
// a_km/b_nk are absorbed by index arithmetic in the global->shared loads
// (each operand lands in shared memory K-outer, whatever its storage), and
// c_nm on the host by computing C^T += alpha * op(B)^T op(A)^T with the
// opposite flags, as matmul.cu does.  Any leading dimension and any shape:
// ragged edges are masked in the kernel, so no workspace is needed.
//
// What bounds it: at the pipeline's superblock (8192^3) a step is 1.10e12
// fp64 operations on 1.5 GiB of operands, about 700 operations a byte, so
// the fp64 tensor cores (67 TFLOP/s) bound it at 16.4 ms, not the bytes
// (0.5 ms).  The design is a plain shared-memory tiling, which is enough to
// feed DMMA well: a 128x64 block tile, 256 threads in 8 warps of 32x32 (16
// m8n8 accumulators, 32 doubles a thread), K in slabs of 16 staged in two
// shared-memory stages through registers, so the next slab's global loads
// overlap this slab's 64 DMMAs a warp.  Each DMMA fragment is one double a
// thread read from shared memory; rows padded to 4 mod 16 doubles keep
// every half-warp's fragment load on distinct banks.  The epilogue loads a
// thread's 32 C values before it stores any (a C update one element at a
// time waited a full memory trip per element in the low-precision kernel).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int LDS_A = BM + 4;  // 132 = 4 mod 16 doubles: conflict-free fragments
constexpr int LDS_B = BN + 4;  // 68 = 4 mod 16
constexpr int A_LOADS = BM * BK / THREADS;  // 8 doubles of A a thread a slab
constexpr int B_LOADS = BN * BK / THREADS;  // 4 of B
constexpr int SMEM_BYTES = 2 * BK * (LDS_A + LDS_B) * 8;  // 51,200: dynamic

static_assert(BM * BK % THREADS == 0 && BN * BK % THREADS == 0,
              "tile loads must divide evenly");

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Element `e` of this thread's share of an (outer x BK) operand slab, mapped
// so that neighbouring threads read neighbouring addresses in global memory:
// along K when the operand is stored K-contiguous, along M (or N) otherwise.
template <bool K_CONTIG, int OUTER>
__device__ __forceinline__ void slab_coord(int e, int& outer, int& kk) {
  const int idx = threadIdx.x + e * THREADS;
  if (K_CONTIG) {
    kk = idx % BK;
    outer = idx / BK;
  } else {
    outer = idx % OUTER;
    kk = idx / OUTER;
  }
}

// A_KM: A stored (K,M); otherwise (M,K).  B_NK: B stored (N,K); otherwise
// (K,N).  C is (M,N) row-major with leading dimension ldc.
template <bool A_KM, bool B_NK>
__global__ void __launch_bounds__(THREADS)
accum_dgemm_kernel(double* __restrict__ c, const double* __restrict__ a,
                   const double* __restrict__ b, double alpha, int M, int N,
                   int K, long long lda, long long ldb, long long ldc) {
  extern __shared__ __align__(16) double smem[];
  double* As = smem;                   // [2][BK][LDS_A], K outer
  double* Bs = smem + 2 * BK * LDS_A;  // [2][BK][LDS_B]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // DMMA fragment coordinates
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  double acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  double ra[A_LOADS], rb[B_LOADS];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_LOADS; ++e) {
      int mm, kk;
      slab_coord<!A_KM, BM>(e, mm, kk);
      const int gm = m0 + mm, gk = k0 + kk;
      ra[e] = (gm < M && gk < K)
                  ? a[A_KM ? (long long)gk * lda + gm : (long long)gm * lda + gk]
                  : 0.0;
    }
#pragma unroll
    for (int e = 0; e < B_LOADS; ++e) {
      int nn, kk;
      slab_coord<B_NK, BN>(e, nn, kk);
      const int gn = n0 + nn, gk = k0 + kk;
      rb[e] = (gn < N && gk < K)
                  ? b[B_NK ? (long long)gn * ldb + gk : (long long)gk * ldb + gn]
                  : 0.0;
    }
  };
  auto store_slab = [&](int s) {
#pragma unroll
    for (int e = 0; e < A_LOADS; ++e) {
      int mm, kk;
      slab_coord<!A_KM, BM>(e, mm, kk);
      As[(s * BK + kk) * LDS_A + mm] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < B_LOADS; ++e) {
      int nn, kk;
      slab_coord<B_NK, BN>(e, nn, kk);
      Bs[(s * BK + kk) * LDS_B + nn] = rb[e];
    }
  };

  const int nslabs = (K + BK - 1) / BK;
  load_slab(0);
  store_slab(0);
  __syncthreads();

  for (int t = 0; t < nslabs; ++t) {
    const int cur = t & 1;
    if (t + 1 < nslabs) load_slab((t + 1) * BK);  // in flight during the DMMAs
    const double* as = As + cur * BK * LDS_A;
    const double* bs = Bs + cur * BK * LDS_B;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      // A fragment: A[row gid][k tig]; B fragment: B[k tig][col gid]
      double af[4], bf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = as[(kk + tig) * LDS_A + wm + i * 8 + gid];
#pragma unroll
      for (int j = 0; j < 4; ++j) bf[j] = bs[(kk + tig) * LDS_B + wn + j * 8 + gid];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j][0], acc[i][j][1], af[i], bf[j]);
    }
    // the other stage was last read before the previous iteration's barrier
    if (t + 1 < nslabs) store_slab(cur ^ 1);
    __syncthreads();
  }

  // accumulator (i, j, h) is C[m0 + wm + 8i + gid][n0 + wn + 8j + 2 tig + h]
  const int row0 = m0 + wm + gid, col0 = n0 + wn + 2 * tig;
  double cv[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * i, col = col0 + 8 * j + h;
        cv[i][j][h] = (r < M && col < N) ? c[(long long)r * ldc + col] : 0.0;
      }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * i, col = col0 + 8 * j + h;
        if (r < M && col < N)
          c[(long long)r * ldc + col] = fma(alpha, acc[i][j][h], cv[i][j][h]);
      }
}

template <bool A_KM, bool B_NK>
cudaError_t launch(double* c, const double* a, const double* b, double alpha,
                   int M, int N, int K, long long lda, long long ldb,
                   long long ldc, cudaStream_t stream) {
  auto kernel = accum_dgemm_kernel<A_KM, B_NK>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(c, a, b, alpha, M, N, K, lda,
                                                 ldb, ldc);
  return cudaGetLastError();
}

cudaError_t launch_rowmajor_c(double* c, const double* a, const double* b,
                              double alpha, int M, int N, int K, bool a_km,
                              bool b_nk, long long lda, long long ldb,
                              long long ldc, cudaStream_t s) {
  if (a_km) {
    if (b_nk) return launch<true, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
    return launch<true, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  }
  if (b_nk) return launch<false, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  return launch<false, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
}

}  // namespace

// C_storage += alpha * op(A) op(B) in float64, launched on `stream` (a
// cudaStream_t); lda/ldb/ldc are the storage leading dimensions in elements.
// Returns the CUDA error of the launch: 0 when the kernel was accepted.
extern "C" int bof_accum_matmul_f64(double* c, const double* a,
                                    const double* b, double alpha, int M,
                                    int N, int K, int a_km, int b_nk, int c_nm,
                                    long long lda, long long ldb,
                                    long long ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;  // nothing to add
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (c_nm) {
    // C^T (N,M) += alpha * op(B)^T op(A)^T: op(B)^T is B's buffer read with
    // the opposite K-major flag, op(A)^T likewise.
    rc = launch_rowmajor_c(c, b, a, alpha, N, M, K, !b_nk, !a_km, ldb, lda,
                           ldc, s);
  } else {
    rc = launch_rowmajor_c(c, a, b, alpha, M, N, K, a_km != 0, b_nk != 0, lda,
                           ldb, ldc, s);
  }
  return static_cast<int>(rc);
}
