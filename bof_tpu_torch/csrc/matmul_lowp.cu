// K1's low-precision variants: C_storage += alpha * op(A) op(B) with A and B
// in bfloat16 (variant 'bf16') or int8 (variant 's8'), C fp32 in place.
//
// 'bf16' replaces bof_tpu/ops/matmul_pallas.py:matmul run on bf16 tiles
// (transfer_dtype='bfloat16': the Pallas kernel's out_dtype=c.dtype keeps an
// fp32 accumulator) together with the epilogue of bof_tpu/ops/device.py:
// accum_step (`c + alpha * out`).  bf16 products are exact in fp32, so the
// result differs from the plain version (bf16 -> fp32, then an fp32 matmul)
// only in summation order.
//
// 's8' replaces the XLA step bof_tpu/ops/device.py:136 accum_step_q
// (transfer_dtype='int8'): int8 x int8 summed EXACTLY in int32, then
// `c + scale * f32(out)` with scale = alpha * s_a * s_b.  The int32 sum is
// exact for any order while 127^2 * K < 2^31, i.e. K <= 131072 (2^17, every
// gemm_blk_size the pipeline uses); a larger K is refused.  The epilogue
// rounds twice, __fadd_rn(c, __fmul_rn(scale, float(acc))), as XLA's
// multiply then add do, so the plain version can match it bit for bit.
//
// Layouts are the eight storage-major ones of matmul.cu: A (M,K) or (K,M)
// with a_km, B (K,N) or (N,K) with b_nk, C (M,N) or (N,M) with c_nm; c_nm is
// the transposed product C^T += op(B)^T op(A)^T, formed by swapping the
// operands on the host.
//
// What bounds it: at the pipeline's superblock (8192^3) a step is
// 1.10e12 operations; the H100's dense tensor cores do 989 TFLOP/s in bf16
// and 1,979 TOPS in int8, i.e. 1.11 ms and 0.56 ms, against 0.25 / 0.19 GB
// of operand traffic (0.08 / 0.06 ms at 3.35 TB/s).  So both are bound by
// tensor-core operations.
//
// The design is the simple one, right first (making it fast is later work):
// - mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32) from shared memory,
//   whose fragments have the same byte layout for both types: a row of 32
//   bytes of K per instruction.  So one kernel body serves both, and only
//   the instruction, the accumulator type and the epilogue differ.
// - A 128 x 128 block tile, 8 warps of 64 x 32, 64 accumulators a thread;
//   64 bytes of K a stage (32 bf16, 64 int8), two shared stages fed through
//   registers so the next stage's global loads overlap this stage's mma.
// - Shared tiles are K-contiguous (rows of M or N, 64 bytes of K, padded to
//   80 so ldmatrix reads without bank conflicts).  An operand stored
//   K-contiguous is copied 16 bytes at a time.  An MN-contiguous one (a_km,
//   or B stored (K,N)) is transposed while it is staged: a thread reads a
//   P x P block (P = 2 bf16 or 4 int8 along both K and M/N, one 32-bit word
//   a K row) and rearranges its bytes with __byte_perm into P words that are
//   K-contiguous; s8 mma takes only K-major operands, so this is what lets
//   it take every layout.
// - Ragged edges and leading dimensions that are not multiples of 16 bytes
//   (a test's small blk): element loads masked at the edges, chosen on the
//   host per launch; nothing is refused for a shape.
// - The tensor cores' fp32 accumulation drops low bits (measured for tf32
//   on wgmma, matmul_tf32.cu).  For one bf16 pass the error that leaves is
//   far inside the fp32 tolerance at 8192^3 (chip_smoke.py checks it), so
//   the accumulators stay in the tensor cores; s8's int32 sum is exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;          // block tile rows (of op(A), or of C)
constexpr int BN = 128;          // block tile columns
constexpr int KB = 64;           // bytes of K a stage: 32 bf16 or 64 int8
constexpr int ROW = KB + 16;     // shared row stride in bytes: ldmatrix rows
                                 // 80 bytes apart hit 8 distinct bank quads
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int WORDS = BM * KB / 4 / THREADS;  // 32-bit words a thread stages
                                              // per operand and stage: 8

static_assert(BM == BN, "one staging routine serves both operands");
static_assert(WORDS == 8, "the staging maps assume 8 words a thread");

enum Kind { BF16 = 0, S8 = 1 };

template <int KIND>
struct Traits;
template <>
struct Traits<BF16> {
  static constexpr int SIZE = 2;  // bytes an element
  using Acc = float;
};
template <>
struct Traits<S8> {
  static constexpr int SIZE = 1;
  using Acc = int;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int SIZE>
__device__ __forceinline__ uint32_t load_elem(const unsigned char* g,
                                              long long idx) {
  if (SIZE == 2) return __ldg(reinterpret_cast<const unsigned short*>(g) + idx);
  return __ldg(g + idx);
}

// ---------------------------------------------------------------- staging
//
// An operand's stage is a (128 rows) x (64 bytes of K) tile; `rows` rows and
// K elements exist, the tile starts at row r0 and element k0.  K_CONTIG: the
// element (r, k) is g[r * ld + k]; otherwise g[k * ld + r].  VEC: the fast
// loads' alignment holds (16 bytes a K-contiguous chunk, 4 bytes an
// MN-contiguous word); edges take masked element loads either way.

// K-contiguous: 512 chunks of 16 bytes, 4 a row; a thread takes 2.
template <int SIZE, bool VEC>
__device__ __forceinline__ void load_kc(uint32_t (&w)[WORDS],
                                        const unsigned char* __restrict__ g,
                                        long long ld, int rows, int K, int r0,
                                        int k0) {
  constexpr int E = 16 / SIZE;  // elements a chunk
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = threadIdx.x + j * THREADS;
    const int r = r0 + (ch >> 2);
    const int k = k0 + (ch & 3) * E;
    uint32_t t[4] = {0u, 0u, 0u, 0u};
    if (r < rows) {
      if (VEC && k + E <= K) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            g + ((long long)r * ld + k) * SIZE));
        t[0] = v.x, t[1] = v.y, t[2] = v.z, t[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (k + e < K)
            t[(e * SIZE) >> 2] |= load_elem<SIZE>(g, (long long)r * ld + k + e)
                                  << (8 * ((e * SIZE) & 3));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) w[4 * j + q] = t[q];
  }
}

__device__ __forceinline__ void store_kc(unsigned char* s,
                                         const uint32_t (&w)[WORDS]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = threadIdx.x + j * THREADS;
    *reinterpret_cast<uint4*>(s + (ch >> 2) * ROW + (ch & 3) * 16) =
        make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
}

// MN-contiguous: blocks of P K-rows x P rows (P = 4 / SIZE), one 32-bit word
// a K-row; 16 word columns x 128 / P row groups of blocks, 8 / P a thread.
// A warp's lanes take 4 word columns x 8 consecutive row groups, so each
// load instruction reads 4 full 32-byte sectors and the transposed stores
// conflict at most 4 ways.
template <int SIZE>
__device__ __forceinline__ void block_coord(int b, int& rb, int& kb) {
  constexpr int P = 4 / SIZE;
  constexpr int RB8 = BM / P / 8;  // row groups of blocks / 8
  const int rest = b >> 5;
  rb = (rest % RB8) * 8 + ((b >> 2) & 7);
  kb = (rest / RB8) * 4 + (b & 3);
}

template <int SIZE, bool VEC>
__device__ __forceinline__ void load_mn(uint32_t (&w)[WORDS],
                                        const unsigned char* __restrict__ g,
                                        long long ld, int rows, int K, int r0,
                                        int k0) {
  constexpr int P = 4 / SIZE;
#pragma unroll
  for (int j = 0; j < WORDS / P; ++j) {
    int rb, kb;
    block_coord<SIZE>(threadIdx.x + j * THREADS, rb, kb);
    const int r = r0 + rb * P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = k0 + kb * P + p;
      uint32_t v = 0u;
      if (k < K) {
        if (VEC && r + P <= rows) {
          v = __ldg(reinterpret_cast<const uint32_t*>(
              g + ((long long)k * ld + r) * SIZE));
        } else {
#pragma unroll
          for (int e = 0; e < P; ++e)
            if (r + e < rows)
              v |= load_elem<SIZE>(g, (long long)k * ld + r + e)
                   << (8 * SIZE * e);
        }
      }
      w[j * P + p] = v;
    }
  }
}

// The P words of a block (word p: K-row p, rows 0..P-1) -> P K-contiguous
// words (word q: row q, K 0..P-1).
template <int SIZE>
__device__ __forceinline__ void transpose(const uint32_t* w, uint32_t* o) {
  if (SIZE == 2) {
    o[0] = __byte_perm(w[0], w[1], 0x5410);
    o[1] = __byte_perm(w[0], w[1], 0x7632);
  } else {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    o[0] = __byte_perm(lo01, lo23, 0x5410);
    o[1] = __byte_perm(lo01, lo23, 0x7632);
    o[2] = __byte_perm(hi01, hi23, 0x5410);
    o[3] = __byte_perm(hi01, hi23, 0x7632);
  }
}

template <int SIZE>
__device__ __forceinline__ void store_mn(unsigned char* s,
                                         const uint32_t (&w)[WORDS]) {
  constexpr int P = 4 / SIZE;
#pragma unroll
  for (int j = 0; j < WORDS / P; ++j) {
    int rb, kb;
    block_coord<SIZE>(threadIdx.x + j * THREADS, rb, kb);
    uint32_t o[P];
    transpose<SIZE>(w + j * P, o);
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<uint32_t*>(s + (rb * P + q) * ROW + kb * 4) = o[q];
  }
}

template <int SIZE, bool K_CONTIG, bool VEC>
__device__ __forceinline__ void load_tile(uint32_t (&w)[WORDS],
                                          const unsigned char* g, long long ld,
                                          int rows, int K, int r0, int k0) {
  if (K_CONTIG)
    load_kc<SIZE, VEC>(w, g, ld, rows, K, r0, k0);
  else
    load_mn<SIZE, VEC>(w, g, ld, rows, K, r0, k0);
}

template <int SIZE, bool K_CONTIG>
__device__ __forceinline__ void store_tile(unsigned char* s,
                                           const uint32_t (&w)[WORDS]) {
  if (K_CONTIG)
    store_kc(s, w);
  else
    store_mn<SIZE>(s, w);
}

// ------------------------------------------------------------------ mma

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: 2 steps of 32 bytes of K over the warp's 64 x 32 tile.
template <typename Acc>
__device__ __forceinline__ void mma_stage(Acc (&acc)[4][4][4],
                                          const unsigned char* sa,
                                          const unsigned char* sb, int wm,
                                          int wn, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldsm_x4(af[mi], sa + (wm * 64 + mi * 16 + (lane & 15)) * ROW + ks * 32 +
                          (lane >> 4) * 16);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t t[4];
      ldsm_x4(t, sb + (wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                          ROW +
                      ks * 32 + ((lane >> 3) & 1) * 16);
      bf[2 * nj][0] = t[0], bf[2 * nj][1] = t[1];
      bf[2 * nj + 1][0] = t[2], bf[2 * nj + 1][1] = t[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
  }
}

__device__ __forceinline__ float epilogue(float alpha, float acc, float c) {
  return fmaf(alpha, acc, c);
}

__device__ __forceinline__ float epilogue(float scale, int acc, float c) {
  return __fadd_rn(c, __fmul_rn(scale, __int2float_rn(acc)));
}

// C (M,N) row-major with leading dimension ldc += alpha * op(A) op(B); A's
// rows are M, B's rows are N, both K-contiguous or not as the flags say.
template <int KIND, bool A_KC, bool B_KC, bool VEC>
__global__ void __launch_bounds__(THREADS)
accum_lowp_kernel(float* __restrict__ c, const unsigned char* __restrict__ a,
                  const unsigned char* __restrict__ b, float alpha, int M,
                  int N, int K, long long lda, long long ldb, long long ldc) {
  using Acc = typename Traits<KIND>::Acc;
  constexpr int SIZE = Traits<KIND>::SIZE;
  constexpr int KE = KB / SIZE;  // elements of K a stage
  __shared__ __align__(16) unsigned char sa[2][BM * ROW];
  __shared__ __align__(16) unsigned char sb[2][BN * ROW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

  uint32_t wa[WORDS], wb[WORDS];
  const int ntiles = (K + KE - 1) / KE;
  load_tile<SIZE, A_KC, VEC>(wa, a, lda, M, K, m0, 0);
  load_tile<SIZE, B_KC, VEC>(wb, b, ldb, N, K, n0, 0);
  store_tile<SIZE, A_KC>(sa[0], wa);
  store_tile<SIZE, B_KC>(sb[0], wb);
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) {  // in flight during this stage's mma
      load_tile<SIZE, A_KC, VEC>(wa, a, lda, M, K, m0, (t + 1) * KE);
      load_tile<SIZE, B_KC, VEC>(wb, b, ldb, N, K, n0, (t + 1) * KE);
    }
    mma_stage(acc, sa[cur], sb[cur], wm, wn, lane);
    // the other stage was last read before the previous iteration's barrier
    if (t + 1 < ntiles) {
      store_tile<SIZE, A_KC>(sa[cur ^ 1], wa);
      store_tile<SIZE, B_KC>(sb[cur ^ 1], wb);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* crow = c + (long long)gm * ldc;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * 32 + ni * 8 + 2 * t4 + e;
          if (gn < N)
            crow[gn] = epilogue(alpha, acc[mi][ni][2 * h + e], crow[gn]);
        }
    }
}

template <int KIND, bool A_KC, bool B_KC>
void launch3(float* c, const void* a, const void* b, float alpha, int M, int N,
             int K, long long lda, long long ldb, long long ldc, bool vec,
             cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* ga = static_cast<const unsigned char*>(a);
  const auto* gb = static_cast<const unsigned char*>(b);
  if (vec)
    accum_lowp_kernel<KIND, A_KC, B_KC, true>
        <<<grid, THREADS, 0, s>>>(c, ga, gb, alpha, M, N, K, lda, ldb, ldc);
  else
    accum_lowp_kernel<KIND, A_KC, B_KC, false>
        <<<grid, THREADS, 0, s>>>(c, ga, gb, alpha, M, N, K, lda, ldb, ldc);
}

// The fast loads need 16-byte chunks for a K-contiguous operand and 4-byte
// words for an MN-contiguous one, in every row.
bool fast_loads(const void* p, long long ld, int size, bool k_contig) {
  const long long need = k_contig ? 16 : 4;
  return reinterpret_cast<uintptr_t>(p) % need == 0 && (ld * size) % need == 0;
}

template <int KIND>
void launch_kind(float* c, const void* a, const void* b, float alpha, int M,
                 int N, int K, bool a_kc, bool b_kc, long long lda,
                 long long ldb, long long ldc, cudaStream_t s) {
  constexpr int SIZE = Traits<KIND>::SIZE;
  const bool vec =
      fast_loads(a, lda, SIZE, a_kc) && fast_loads(b, ldb, SIZE, b_kc);
  if (a_kc && b_kc)
    launch3<KIND, true, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, vec, s);
  else if (a_kc)
    launch3<KIND, true, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, vec, s);
  else if (b_kc)
    launch3<KIND, false, true>(c, a, b, alpha, M, N, K, lda, ldb, ldc, vec, s);
  else
    launch3<KIND, false, false>(c, a, b, alpha, M, N, K, lda, ldb, ldc, vec, s);
}

}  // namespace

// C_storage += alpha * op(A) op(B) with A and B bf16 (kind 0) or int8
// (kind 1), launched on `stream` (a cudaStream_t); lda/ldb/ldc are the
// storage leading dimensions in elements.  For int8 alpha is the scale
// alpha * s_a * s_b and K may be at most 131072 (the int32 sum is exact up
// to there).  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a K or kind it refuses): 0 when accepted.
extern "C" int bof_accum_matmul_lowp(float* c, const void* a, const void* b,
                                     float alpha, int M, int N, int K,
                                     int a_km, int b_nk, int c_nm,
                                     long long lda, long long ldb,
                                     long long ldc, int kind, void* stream) {
  if (kind != BF16 && kind != S8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == S8 && K > (1 << 17))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0) return 0;  // nothing to add
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A (M,K) row-major is K-contiguous; B is K-contiguous when stored (N,K).
  // c_nm: C^T (N,M) += op(B)^T op(A)^T, whose "A" is B's buffer (rows N)
  // and whose "B" is A's buffer (rows M).
  const bool a_kc = !a_km, b_kc = b_nk != 0;
  if (kind == BF16) {
    if (c_nm)
      launch_kind<BF16>(c, b, a, alpha, N, M, K, b_kc, a_kc, ldb, lda, ldc, s);
    else
      launch_kind<BF16>(c, a, b, alpha, M, N, K, a_kc, b_kc, lda, ldb, ldc, s);
  } else {
    if (c_nm)
      launch_kind<S8>(c, b, a, alpha, N, M, K, b_kc, a_kc, ldb, lda, ldc, s);
    else
      launch_kind<S8>(c, a, b, alpha, M, N, K, a_kc, b_kc, lda, ldb, ldc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
