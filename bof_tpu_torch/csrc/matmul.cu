// Accumulate matmul for the out-of-core SGEMM: C_storage += alpha * op(A) op(B).
//
// Replaces bof_tpu/ops/matmul_pallas.py:matmul (the Pallas MXU kernel) together
// with the epilogue of bof_tpu/ops/device.py:accum_step (`c + alpha * out`):
// the partial product never leaves registers, each superblock step reads C
// once and writes it once.
//
// Layouts are those of the Pallas kernel, in storage-major order:
//   A is (M,K) row-major, or (K,M) with a_km;
//   B is (K,N) row-major, or (N,K) with b_nk;
//   C is (M,N) row-major, or (N,M) with c_nm.
// a_km/b_nk are handled by index arithmetic in the global->shared loads; c_nm
// is handled on the host by computing the transposed product
// C^T += alpha * op(B)^T op(A)^T, whose operands are the same buffers with the
// opposite flags (the Pallas kernel's dot_general(b, a) for c_nm).  No pass
// transposes anything.  Ragged M/N/K edges are masked in the kernel, so any
// shape is accepted.
//
// What bounds it: at the pipeline's superblock (blk 8192) each step does
// 2 * 8192^3 = 1.1 TFLOP on 768 MiB of operands (A, B, C at 256 MiB each),
// about 1400 FLOP per byte of device memory, so the step is bound by fp32
// FFMA throughput, not by bytes.  The design does what a classic FFMA SGEMM
// does about that: a 128x128 block tile, BK = 8, 256 threads each holding an
// 8x8 fp32 accumulator in registers (64 FFMA per 4 shared-memory float4
// loads), and two shared-memory stages fed through registers so the next
// tile's global loads overlap this tile's FFMAs.  It keeps full fp32 with
// sequential fmaf accumulation, which is what matmul_precision='highest'
// promises; one TF32 tensor-core pass would not.
//
// This is K1's FFMA variant: ops/matmul_cuda.py:k1_variant sends here the
// shapes whose leading dimensions or base addresses TMA cannot describe;
// everything else goes to the tensor-core variants in matmul_tf32.cu.  An
// s8 variant for the int8 transfer mode is ROADMAP B4.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int PAD = 4;  // keeps the transposing shared stores conflict-free
constexpr int THREADS = 256;
constexpr int LOADS = BM * BK / THREADS;  // 4 elements of A (and of B) per thread

static_assert(BM == BN, "tile loads assume a square block tile");
static_assert(BM * BK % THREADS == 0, "tile loads must divide evenly");

// Element `e` of this thread's share of an (outer x BK) operand tile, mapped
// so neighbouring threads read neighbouring addresses in global memory: along
// K when the operand is stored K-contiguous, along M (or N) otherwise.
template <bool K_CONTIG>
__device__ __forceinline__ void tile_coord(int e, int& outer, int& kk) {
  const int idx = threadIdx.x + e * THREADS;
  if (K_CONTIG) {
    kk = idx % BK;
    outer = idx / BK;
  } else {
    outer = idx % BM;
    kk = idx / BM;
  }
}

// A_KM: A stored (K,M); otherwise (M,K).  B_NK: B stored (N,K); otherwise
// (K,N).  C is (M,N) row-major with leading dimension ldc.
template <bool A_KM, bool B_NK>
__global__ void __launch_bounds__(THREADS)
accum_sgemm_kernel(float* __restrict__ c, const float* __restrict__ a,
                   const float* __restrict__ b, float alpha, int M, int N,
                   int K, long long lda, long long ldb, long long ldc) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tx = threadIdx.x % 16;  // output columns tx*4.., 64+tx*4..
  const int ty = threadIdx.x / 16;  // output rows ty*4.., 64+ty*4..
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[LOADS], rb[LOADS];

  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      int mm, kk;
      tile_coord<!A_KM>(e, mm, kk);
      const int gm = m0 + mm, gk = k0 + kk;
      ra[e] = (gm < M && gk < K)
                  ? a[A_KM ? (long long)gk * lda + gm : (long long)gm * lda + gk]
                  : 0.f;
      int nn;
      tile_coord<B_NK>(e, nn, kk);
      const int gn = n0 + nn, gk2 = k0 + kk;
      rb[e] = (gn < N && gk2 < K)
                  ? b[B_NK ? (long long)gn * ldb + gk2 : (long long)gk2 * ldb + gn]
                  : 0.f;
    }
  };
  auto store_tiles = [&](int s) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      int mm, kk;
      tile_coord<!A_KM>(e, mm, kk);
      As[s][kk][mm] = ra[e];
      int nn;
      tile_coord<B_NK>(e, nn, kk);
      Bs[s][kk][nn] = rb[e];
    }
  };

  const int ntiles = (K + BK - 1) / BK;
  load_tiles(0);
  store_tiles(0);
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) load_tiles((t + 1) * BK);  // in flight during the FFMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other stage was last read before the previous iteration's barrier
    if (t + 1 < ntiles) store_tiles(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
    float* crow = c + (long long)gm * ldc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < N) crow[gn] = fmaf(alpha, acc[i][j], crow[gn]);
    }
  }
}

template <bool A_KM, bool B_NK>
void launch(float* c, const float* a, const float* b, float alpha, int M,
            int N, int K, long long lda, long long ldb, long long ldc,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  accum_sgemm_kernel<A_KM, B_NK>
      <<<grid, THREADS, 0, stream>>>(c, a, b, alpha, M, N, K, lda, ldb, ldc);
}

void launch_rowmajor_c(float* c, const float* a, const float* b, float alpha,
                       int M, int N, int K, bool a_km, bool b_nk,
                       long long lda, long long ldb, long long ldc,
                       cudaStream_t s) {
  if (a_km) {
    if (b_nk) launch<true, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
    else launch<true, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  } else {
    if (b_nk) launch<false, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
    else launch<false, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  }
}

}  // namespace

// C_storage += alpha * op(A) op(B), launched on `stream` (a cudaStream_t);
// lda/ldb/ldc are the storage leading dimensions in elements.  Returns
// cudaGetLastError() after the launch: 0 when the kernel was accepted.
extern "C" int bof_accum_matmul_f32(float* c, const float* a, const float* b,
                                    float alpha, int M, int N, int K,
                                    int a_km, int b_nk, int c_nm,
                                    long long lda, long long ldb,
                                    long long ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;  // nothing to add
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_nm) {
    // C^T (N,M) += alpha * op(B)^T op(A)^T: op(B)^T is B's buffer read with
    // the opposite K-major flag, op(A)^T likewise.
    launch_rowmajor_c(c, b, a, alpha, N, M, K, !b_nk, !a_km, ldb, lda, ldc, s);
  } else {
    launch_rowmajor_c(c, a, b, alpha, M, N, K, a_km != 0, b_nk != 0, lda, ldb,
                      ldc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
