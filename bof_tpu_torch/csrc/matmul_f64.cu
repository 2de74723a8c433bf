// K1 variant 'f64': C_storage += alpha * op(A) op(B), all float64, on Hopper's
// fp64 tensor cores (DMMA, mma.sync.aligned.m16n8k4.row.col.f64).
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
// Shared memory keeps each operand tile in its storage layout and the
// fragment loads index it per layout, so a_km/b_nk cost nothing; c_nm is
// absorbed on the host by computing C^T += alpha * op(B)^T op(A)^T with the
// opposite flags, as matmul_tf32.cu does.  Any leading dimension and any
// shape: ragged edges are zero-filled by the copies and masked in the
// epilogue, so no workspace is needed.
//
// What bounds it: at the pipeline's superblock (8192^3) a step is 1.10e12
// fp64 operations on 1.5 GiB of operands, about 700 operations a byte, so
// the fp64 tensor cores (67 TFLOP/s) bound it at 16.4 ms, not the bytes
// (0.5 ms).  The design keeps DMMA fed from one 256-thread block a SM:
// - a 128x128 block tile in 8 warps of 64x32 (16 MMA tiles, 64 accumulators
//   a thread), with sm_90's m16n8k4 shape (k8 and k16 ran no faster and
//   need more fragment registers);
// - K in tiles of 16 through a ring of 4 shared-memory stages filled by
//   cp.async, every stage in flight and one barrier a tile.  A copy moves
//   16 bytes where the operand's leading dimension is even and its base
//   16-byte aligned, else 8 (an odd leading dimension of doubles; TMA takes
//   neither); a copy that crosses M, N or K reads only what lies inside and
//   zero-fills the rest;
// - each K step loads the next step's fragments (scalar ld.shared, 8-byte
//   elements) while its 16 MMAs run, and a tile's last step issues its MMAs
//   before the barrier, so the barrier overlaps tensor-core work; rows
//   padded to 4 mod 16 doubles keep each half-warp on distinct banks in
//   both storage layouts;
// - blocks are rasterized in groups of 8 block rows, so the blocks in flight
//   share B's column panels in L2;
// - the epilogue loads a 16-row band's C values before it stores any (a C
//   update one element at a time waited a full memory trip per element).
// Each C element adds its products in k order with fp64 fma, as the first
// (m8n8k4) design did; no split-K and no atomics, so runs are bit-identical.
// tools/torch_k1_f64_variants.py builds and times the design's alternatives
// as text edits of this file.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int MMA_K = 4;
constexpr int KV = MMA_K / 4;  // B doubles a thread an MMA (A: 2 * KV)
constexpr int KSTEPS = BK / MMA_K;  // MMA steps a K tile
constexpr int THREADS = 256;
constexpr int WM = 64, WN = 32;  // warp tile: 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;  // 4 x 4 MMA tiles a warp
constexpr int GROUP_M = 8;  // block rows a raster group
// copies of a tile a thread issues back to back: all of the 16-byte ones;
// the 8-byte ones (twice as many) two at a time, since fully unrolled the
// compiler keeps every copy's address live across the mainloop and spills
constexpr int WIDE_UNROLL = 4;
constexpr int NARROW_UNROLL = 2;

static_assert(BK % MMA_K == 0 && BK % 16 == 0, "BK is whole MMAs and rows");
static_assert(KSTEPS % 2 == 0, "fragment buffers alternate within a tile");
static_assert(STAGES >= 2, "a ring");
static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "8 warps");

// An operand tile of OUTER (M or N) x BK in its storage layout: K-contiguous
// as [OUTER][BK + 4], else [BK][OUTER + 4]; both strides are 4 mod 16
// doubles (fragment loads conflict-free) and even (16-byte copies aligned).
template <bool K_CONTIG, int OUTER>
struct Tile {
  static constexpr int LD = K_CONTIG ? BK + 4 : OUTER + 4;
  static constexpr int SIZE = K_CONTIG ? OUTER * LD : BK * LD;
  static_assert(LD % 16 == 4, "conflict-free fragment loads");
  __device__ static __forceinline__ int at(int o, int k) {
    return K_CONTIG ? o * LD + k : k * LD + o;
  }
};

template <bool A_KM, bool B_NK>
constexpr int smem_bytes() {
  return STAGES * (Tile<!A_KM, BM>::SIZE + Tile<B_NK, BN>::SIZE) * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V doubles from src to dst; only `bytes` of them are read, the rest of the
// destination is zero-filled (0 bytes: all zero, src not read).
template <int V>
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int bytes) {
  if (V == 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One K tile of an operand (rows o0.., columns k0.. of the logical OUTER x K
// operand, stored K-contiguous or not with leading dimension ld) into s,
// V doubles a copy along the storage's contiguous dimension.
template <bool K_CONTIG, int OUTER, int V>
__device__ __forceinline__ void load_tile(double* s, const double* g,
                                          long long ld, int o0, int k0,
                                          int outer_n, int K) {
  using T = Tile<K_CONTIG, OUTER>;
  constexpr int CONTIG = K_CONTIG ? BK : OUTER;
  constexpr int PER_ROW = CONTIG / V;
  constexpr int COPIES = (K_CONTIG ? OUTER : BK) * PER_ROW / THREADS;
  static_assert(COPIES * THREADS == (K_CONTIG ? OUTER : BK) * PER_ROW,
                "copies divide evenly");
  auto copy = [&](int e) {
    const int idx = threadIdx.x + e * THREADS;
    const int row = idx / PER_ROW, col = (idx % PER_ROW) * V;
    const int o = K_CONTIG ? o0 + row : o0 + col;
    const int k = K_CONTIG ? k0 + col : k0 + row;
    // elements of this copy inside the operand, along its contiguous run
    int valid = K_CONTIG ? (o < outer_n ? K - k : 0)
                         : (k < K ? outer_n - o : 0);
    valid = valid < 0 ? 0 : (valid > V ? V : valid);
    const double* src =
        valid ? g + (K_CONTIG ? (long long)o * ld + k : (long long)k * ld + o)
              : g;
    cp_async<V>(s + row * T::LD + col, src, valid * 8);
  };
  if constexpr (V == 2) {
#pragma unroll WIDE_UNROLL
    for (int e = 0; e < COPIES; ++e) copy(e);
  } else {
#pragma unroll NARROW_UNROLL
    for (int e = 0; e < COPIES; ++e) copy(e);
  }
}

// d += a b on a 16x8 tile: A fragment a[v] = A(gid + 8 (v % 2), tig + 4 (v / 2)),
// B fragment b[v] = B(tig + 4 v, gid), accumulator d[v] = D(gid + 8 (v / 2),
// 2 tig + v % 2) (PTX ISA, mma.m16n8k{4,8,16} .f64).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2 * KV],
                                     const double (&b)[KV]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// A_KM: A stored (K,M); otherwise (M,K).  B_NK: B stored (N,K); otherwise
// (K,N).  C is (M,N) row-major with leading dimension ldc.  VA, VB: doubles
// a copy of A and of B (2 needs an even leading dimension and a 16-byte
// aligned base).
template <bool A_KM, bool B_NK, int VA, int VB>
__global__ void __launch_bounds__(THREADS, 1)
accum_dgemm_kernel(double* __restrict__ c, const double* __restrict__ a,
                   const double* __restrict__ b, double alpha, int M, int N,
                   int K, long long lda, long long ldb, long long ldc) {
  using TA = Tile<!A_KM, BM>;
  using TB = Tile<B_NK, BN>;
  extern __shared__ __align__(16) double smem[];
  double* As = smem;                   // [STAGES][TA::SIZE]
  double* Bs = smem + STAGES * TA::SIZE;  // [STAGES][TB::SIZE]

  // grouped raster: GROUP_M block rows sweep the block columns together
  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * grid_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * GROUP_M;
  const int rows_here = min(grid_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows_here) * BM;
  const int n0 = (in_group / rows_here) * BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // MMA fragment coordinates
  const int wm = (warp % (BM / WM)) * WM, wn = (warp / (BM / WM)) * WN;

  double acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;

  const int ktiles = (K + BK - 1) / BK;
  auto load_stage = [&](int kt) {
    const int s = kt % STAGES;
    load_tile<!A_KM, BM, VA>(As + s * TA::SIZE, a, lda, m0, kt * BK, M, K);
    load_tile<B_NK, BN, VB>(Bs + s * TB::SIZE, b, ldb, n0, kt * BK, N, K);
  };
  // fragments of K step kk of the tile in stage st, into buffer f
  double fa[2][MT][2 * KV], fb[2][NT][KV];
  auto load_frags = [&](int f, int st, int kk) {
    const double* as = As + st * TA::SIZE;
    const double* bs = Bs + st * TB::SIZE;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int v = 0; v < 2 * KV; ++v)
        fa[f][i][v] = as[TA::at(wm + 16 * i + gid + 8 * (v % 2),
                                kk + tig + 4 * (v / 2))];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < KV; ++v)
        fb[f][j][v] = bs[TB::at(wn + 8 * j + gid, kk + tig + 4 * v)];
  };
  auto mmas = [&](int f) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) dmma(acc[i][j], fa[f][i], fb[f][j]);
  };

  // ring prologue: every stage in flight, then tile 0's first fragments
#pragma unroll
  for (int kt = 0; kt < STAGES; ++kt) {
    if (kt < ktiles) load_stage(kt);
    cp_async_commit();  // an empty group keeps the count of groups fixed
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  load_frags(0, 0, 0);

  // Each K step loads the next step's fragments while its MMAs run; the
  // last step of a tile issues its MMAs first, then waits for the next
  // tile, so the barrier overlaps tensor-core work, and refills the stage
  // every warp has just finished reading.
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % STAGES;
#pragma unroll
    for (int step = 0; step < KSTEPS; ++step) {
      if (step + 1 < KSTEPS) {
        load_frags((step + 1) % 2, st, (step + 1) * MMA_K);
        mmas(step % 2);
      } else {
        mmas(step % 2);
        cp_async_wait<STAGES - 2>();  // tile kt + 1 has landed (this thread)
        __syncthreads();              // ... every thread's; stage st is free
        if (kt + STAGES < ktiles) load_stage(kt + STAGES);
        cp_async_commit();
        if (kt + 1 < ktiles) load_frags(0, (kt + 1) % STAGES, 0);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, v) is C[row0 + 16 i + 8 (v / 2)][col0 + 8 j + v % 2]
  const int row0 = m0 + wm + gid, col0 = n0 + wn + 2 * tig;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    double cv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = row0 + 16 * i + 8 * (v / 2), col = col0 + 8 * j + v % 2;
        cv[j][v] = (r < M && col < N) ? c[(long long)r * ldc + col] : 0.0;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = row0 + 16 * i + 8 * (v / 2), col = col0 + 8 * j + v % 2;
        if (r < M && col < N)
          c[(long long)r * ldc + col] = fma(alpha, acc[i][j][v], cv[j][v]);
      }
  }
}

template <bool A_KM, bool B_NK, int VA, int VB>
cudaError_t launch(double* c, const double* a, const double* b, double alpha,
                   int M, int N, int K, long long lda, long long ldb,
                   long long ldc, cudaStream_t stream) {
  auto kernel = accum_dgemm_kernel<A_KM, B_NK, VA, VB>;
  constexpr int bytes = smem_bytes<A_KM, B_NK>();
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  const long long blocks =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, THREADS, bytes, stream>>>(c, a, b, alpha, M, N,
                                                       K, lda, ldb, ldc);
  return cudaGetLastError();
}

// 16-byte copies need an even leading dimension and a 16-byte aligned base
bool wide(const double* p, long long ld) {
  return ld % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool A_KM, bool B_NK>
cudaError_t launch_vec(double* c, const double* a, const double* b,
                       double alpha, int M, int N, int K, long long lda,
                       long long ldb, long long ldc, cudaStream_t s) {
  const bool wa = wide(a, lda), wb = wide(b, ldb);
  if (wa && wb)
    return launch<A_KM, B_NK, 2, 2>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  if (wa)
    return launch<A_KM, B_NK, 2, 1>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  if (wb)
    return launch<A_KM, B_NK, 1, 2>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  return launch<A_KM, B_NK, 1, 1>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
}

cudaError_t launch_rowmajor_c(double* c, const double* a, const double* b,
                              double alpha, int M, int N, int K, bool a_km,
                              bool b_nk, long long lda, long long ldb,
                              long long ldc, cudaStream_t s) {
  if (a_km) {
    if (b_nk)
      return launch_vec<true, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
    return launch_vec<true, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  }
  if (b_nk)
    return launch_vec<false, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
  return launch_vec<false, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, s);
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
