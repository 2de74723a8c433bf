// Accumulate matmul on the tensor cores: C_storage += alpha * op(A) op(B),
// fp32 in and out, K1's fp32 variants ('tf32x3' and 'tf32').
//
// Replaces bof_tpu/ops/matmul_pallas.py:matmul (the Pallas MXU kernel) and
// the epilogue of bof_tpu/ops/device.py:accum_step (`c + alpha * out`) for
// every fp32 operand: any layout, leading dimension and base address.
// Layouts are K1's eight storage-major ones: A (M,K) or (K,M) with a_km,
// B (K,N) or (N,K) with b_nk, C (M,N) or (N,M) with c_nm.
//
// Precision.  PASSES = 3 ('highest', 'high') is 3xTF32: every operand is
// split as x = hi + lo with hi = x truncated to TF32 (the low 13 mantissa
// bits dropped, which is what wgmma does to a raw fp32 operand) and
// lo = x - hi exactly; the product sums lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// in fp32, so only lo_a*lo_b (about 2^-22 relative) is lost: fp32-class
// accuracy, more than the TPU's 6-pass bf16 'highest' keeps.  PASSES = 1
// ('default') is one TF32 pass: 11 significant bits, more than the TPU's
// one bf16 pass (8).
//
// What bounds it: at the pipeline's superblock (8192^3) a step is
// 2 * 8192^3 = 1.10e12 FLOP on 1 GiB of operand traffic (A, B and C read,
// C written); three TF32 passes at the H100's 495 TFLOP/s take 6.66 ms,
// the bytes 0.32 ms at 3.35 TB/s, so it is bound by tensor-core operations
// (one pass: 2.22 ms).
//
// How the design meets it:
// - wgmma reads tf32 operands from shared memory only K-major, and TMA
//   reads an operand only where its base is 16-byte aligned and its rows
//   a multiple of 16 bytes apart.  A split pass (hopper.cuh:
//   tf32_prepare) first writes, for each operand, a K-major copy at a
//   leading dimension of K rounded up to 32 floats (rows on 128-byte
//   lines, which TMA reads fastest) when its storage is not
//   K-major (a_km, or B stored (K,N)) or TMA cannot read it where it lies
//   (a leading dimension that is not a multiple of 4 floats, or a base
//   that is not 16-byte aligned), and lo when PASSES = 3;
//   a K-major operand TMA can read is read in place, raw, as its own hi.
//   The pass reads each operand once and writes it once or twice: at
//   8192^3 R/N/N about 1.3 GB in all, 0.55 ms on the H100 against 9.4 ms
//   for the product (PERF.md).
// - The product kernel (accum_tf32_kernel) keeps a ring of shared-memory
//   stages (192 KiB) filled by TMA (cp.async.bulk.tensor, 64-byte swizzle,
//   an mbarrier a stage counting the bytes in).  Two warpgroups each own
//   64 rows of a 128 x 256 block tile, 128 fp32 accumulators a thread;
//   whichever of the two finishes with a stage last refills it.  There is
//   no producer warp: a ninth warp would cap ptxas at 168 registers a
//   thread, and the 3-pass variant needs about 200.
// - With PASSES = 3 each stage's 3 x 16 products go into a fresh
//   accumulator and are then added to the fp32 accumulators
//   (hopper.cuh: tf32x3_stage), since the tensor cores' own accumulation
//   drops low bits.  With PASSES = 1 wgmma.m64n256k8 accumulates in place,
//   one group in flight while the next stage is awaited.
// - Ragged M/N/K edges: TMA fills out-of-bounds boxes with zeros, and the
//   epilogue masks its stores.  c_nm is the transposed product
//   C^T += op(B)^T op(A)^T, formed by swapping the two K-major operands.
// - Epilogue: C += alpha * acc straight from the accumulator fragment, so
//   a step reads C once and writes it once.
// - Tiles are visited in groups of 16 block rows, so one wave of blocks
//   shares its A and B tiles in L2.

#include <cuda.h>  // CUtensorMap and the driver API's types; not linked
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;          // block tile rows: 2 consumer warpgroups x 64
constexpr int BN = 256;          // block tile columns: wgmma n256
constexpr int BK = 16;           // fp32 along K per stage: one 64-byte row
constexpr int GROUP_M = 16;      // block rows per raster group (L2 reuse)
constexpr int WG = 128;          // threads in a warpgroup
// two warpgroups and no producer warp: with 8 warps, 2 on each SM
// sub-partition, ptxas may give a thread 255 registers (a ninth warp
// would cap it at 168 and spill the 3-pass accumulators)
constexpr int THREADS = 2 * WG;
constexpr int TILE_P = BM * BK * 4;  // bytes of one P (rows of C) tile
constexpr int TILE_Q = BN * BK * 4;  // bytes of one Q (columns of C) tile

template <int PASSES>
struct Ring {
  static constexpr int STAGE_BYTES = (TILE_P + TILE_Q) * (PASSES == 3 ? 2 : 1);
  static constexpr int STAGES = 196608 / STAGE_BYTES;  // 192 KiB of tiles
  // stages, then an mbarrier and a counter a stage, plus slack to align
  // the base to 1 KiB
  static constexpr int SMEM = STAGES * STAGE_BYTES + STAGES * 12 + 1024;
};

// d += A(64x8, K-major, desc a) * B(8x256, K-major, desc b), tf32 in, fp32
// accumulate, for the executing warpgroup.
__device__ __forceinline__ void wgmma_m64n256k8(float (&d)[128], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "
      "%94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// --------------------------------------------------------------- kernels

// K-tile kt of the four operands (two when PASSES == 1) into its stage of
// the ring, reported to the stage's full barrier as bytes.
template <int PASSES>
__device__ __forceinline__ void load_stage(
    int kt, uint32_t ring, uint32_t full, const CUtensorMap* p_x,
    const CUtensorMap* q_x, const CUtensorMap* p_lo, const CUtensorMap* q_lo,
    int m0, int n0) {
  using R = Ring<PASSES>;
  const int s = kt % R::STAGES;
  const uint32_t stage = ring + s * R::STAGE_BYTES, bar = full + 8 * s;
  mbar_expect_tx(bar, R::STAGE_BYTES);
  tma_load(stage, p_x, bar, kt * BK, m0);
  tma_load(stage + TILE_P, q_x, bar, kt * BK, n0);
  if (PASSES == 3) {
    tma_load(stage + TILE_P + TILE_Q, p_lo, bar, kt * BK, m0);
    tma_load(stage + 2 * TILE_P + TILE_Q, q_lo, bar, kt * BK, n0);
  }
}

// D (M x N, row-major, ldd) += alpha * P Q^T, where P (M x K) and Q (N x K)
// are K-major and read through tensor maps: p_x/q_x the operands (TF32 hi by
// truncation), p_lo/q_lo their lo parts (read when PASSES == 3).
template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
accum_tf32_kernel(const __grid_constant__ CUtensorMap p_x,
                  const __grid_constant__ CUtensorMap q_x,
                  const __grid_constant__ CUtensorMap p_lo,
                  const __grid_constant__ CUtensorMap q_lo,
                  float* __restrict__ d, long long ldd, float alpha, int M,
                  int N, int K) {
  using R = Ring<PASSES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + R::STAGES * R::STAGE_BYTES;  // mbarriers
  // per stage, how many warpgroups have finished reading it (mod 2)
  uint32_t* done = reinterpret_cast<uint32_t*>(
      smem + R::STAGES * R::STAGE_BYTES + 8 * R::STAGES);

  // grouped raster: GROUP_M block rows, block rows fastest within a group
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int group = blockIdx.x / (GROUP_M * tiles_n);
  const int first_m = group * GROUP_M;
  const int group_m = min(GROUP_M, tiles_m - first_m);
  const int in_group = blockIdx.x % (GROUP_M * tiles_n);
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);  // the loader's expect_tx arrival
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kt = 0; kt < min(R::STAGES, ktiles); ++kt)
      load_stage<PASSES>(kt, ring, full, &p_x, &q_x, &p_lo, &q_lo, m0, n0);
  }
  __syncthreads();

  // One thread of each warpgroup calls this once the warpgroup's wgmmas no
  // longer read K-tile kt's stage; the second of the two refills the stage
  // with K-tile kt + STAGES.  So no warp is spent on loading alone.
  auto release = [&](int kt) {
    const int s = kt % R::STAGES;
    __threadfence_block();
    if (atomicAdd(&done[s], 1u) % 2 == 1 && kt + R::STAGES < ktiles)
      load_stage<PASSES>(kt + R::STAGES, ring, full, &p_x, &q_x, &p_lo,
                         &q_lo, m0, n0);
  };

  // warpgroup wg owns rows wg*64 .. wg*64+63 of the block tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t p_off = wg * 64 * BK * 4;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % R::STAGES;
    const uint32_t stage = ring + s * R::STAGE_BYTES;
    mbar_wait(full + 8 * s, (kt / R::STAGES) & 1);
    const uint64_t px = tf32_desc<BK>(stage + p_off);
    const uint64_t qx = tf32_desc<BK>(stage + TILE_P);
    if constexpr (PASSES == 3) {
      tf32x3_stage<BN / 128, BK>(
          acc, px, qx, tf32_desc<BK>(stage + TILE_P + TILE_Q + p_off),
          tf32_desc<BK>(stage + 2 * TILE_P + TILE_Q));
      if (threadIdx.x % WG == 0) release(kt);
    } else {
      // one TF32 pass accumulates on the tensor cores: its 2^-11 input
      // rounding dwarfs what their accumulation drops
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / TF32_WK; ++kk) {
        const uint64_t step = (kk * TF32_WK * 4) >> 4;  // 16-byte units
        wgmma_m64n256k8(acc, px + step, qx + step);
      }
      wgmma_commit();
      fence_acc(acc);
      // keep this stage's group in flight; the previous one is done, so
      // its stage can be refilled
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && threadIdx.x % WG == 0) release(kt - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: the m64nNk8 fp32 fragment holds, for 8-column chunk j,
  // acc[4j + 2i + e] at row warp*16 + lane/4 + 8i, column 8j + 2(lane%4) + e
  const int t = threadIdx.x % WG;
  const int row0 = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= M) continue;
    float* drow = d + (long long)row * ldd;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + e;
        if (col < N) drow[col] = fmaf(alpha, acc[4 * j + 2 * i + e], drow[col]);
      }
    }
  }
}

// ------------------------------------------------------------------ host

template <int PASSES>
cudaError_t launch_product(const CUtensorMap& px, const CUtensorMap& qx,
                           const CUtensorMap& pl, const CUtensorMap& ql,
                           float* d, long long ldd, float alpha, int M, int N,
                           int K, cudaStream_t s) {
  using R = Ring<PASSES>;
  cudaError_t rc = cudaFuncSetAttribute(
      accum_tf32_kernel<PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::SMEM);
  if (rc != cudaSuccess) return rc;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  accum_tf32_kernel<PASSES><<<(unsigned)tiles, THREADS, R::SMEM, s>>>(
      px, qx, pl, ql, d, ldd, alpha, M, N, K);
  return cudaSuccess;
}

}  // namespace

// C_storage += alpha * op(A) op(B) on the tensor cores, launched on `stream`
// (a cudaStream_t): passes 3 is 3xTF32, passes 1 one TF32 pass.  lda/ldb/ldc
// are the storage leading dimensions in elements.  The workspaces, each
// (rows x K) K-major with leading dimension ldw (a multiple of 4), are
// allocated by the caller and may be null where unused: a_x (M rows) when
// op(A) is rewritten K-major (a_km, or lda or A's base not as TMA reads),
// b_x (N rows) likewise for B (stored (K,N), or ldb or its base), a_lo and
// b_lo when passes is 3 (ops/matmul_cuda.py:k1_workspace).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// argument it cannot take (a missing workspace, a tensor map the driver
// refuses, passes other than 1 or 3).
extern "C" int bof_accum_matmul_tf32(float* c, const float* a, const float* b,
                                     float alpha, int M, int N, int K,
                                     int a_km, int b_nk, int c_nm,
                                     long long lda, long long ldb,
                                     long long ldc, int passes, float* a_x,
                                     float* a_lo, float* b_x, float* b_lo,
                                     long long ldw, void* stream) {
  if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0) return 0;  // nothing to add
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // P = op(A) (M x K) and Q = op(B)^T (N x K), both K-major
  const float *p, *q;
  long long ldp, ldq;
  if (!tf32_prepare(a, lda, !a_km, M, K, passes, a_x, a_lo, ldw, &p, &ldp,
                    s) ||
      !tf32_prepare(b, ldb, b_nk != 0, N, K, passes, b_x, b_lo, ldw, &q, &ldq,
                    s))
    return cudaErrorInvalidValue;
  const float* p_lo = passes == 3 ? a_lo : p;
  const float* q_lo = passes == 3 ? b_lo : q;
  long long ldp_lo = passes == 3 ? ldw : ldp, ldq_lo = passes == 3 ? ldw : ldq;
  int rows_p = M, rows_q = N;
  if (c_nm) {  // C^T (N x M) += op(B)^T op(A)^T: swap the two operands
    const float* t = p; p = q; q = t;
    t = p_lo; p_lo = q_lo; q_lo = t;
    long long u = ldp; ldp = ldq; ldq = u;
    u = ldp_lo; ldp_lo = ldq_lo; ldq_lo = u;
    rows_p = N;
    rows_q = M;
  }
  CUtensorMap px, qx, pl, ql;
  if (!tf32_kmajor_map(&px, p, rows_p, K, ldp, BM, BK) ||
      !tf32_kmajor_map(&qx, q, rows_q, K, ldq, BN, BK) ||
      !tf32_kmajor_map(&pl, p_lo, rows_p, K, ldp_lo, BM, BK) ||
      !tf32_kmajor_map(&ql, q_lo, rows_q, K, ldq_lo, BN, BK))
    return cudaErrorInvalidValue;
  const cudaError_t rc =
      passes == 3
          ? launch_product<3>(px, qx, pl, ql, c, ldc, alpha, rows_p, rows_q,
                              K, s)
          : launch_product<1>(px, qx, pl, ql, c, ldc, alpha, rows_p, rows_q,
                              K, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
