// K1's low-precision variants: C_storage += alpha * op(A) op(B) with A and B
// in bfloat16 (variant 'bf16') or int8 (variant 's8'), C fp32 in place.
//
// 'bf16' replaces bof_tpu/ops/matmul_pallas.py:matmul run on bf16 tiles
// (transfer_dtype='bfloat16': the Pallas kernel's out_dtype=c.dtype keeps an
// fp32 accumulator) together with the epilogue of bof_tpu/ops/device.py:
// accum_step (`c + alpha * out`, here fmaf(alpha, acc, c)).  bf16 products
// are exact in fp32, so the result differs from the plain version (bf16 ->
// fp32, then an fp32 matmul) only in summation order.
//
// 's8' replaces the XLA step bof_tpu/ops/device.py:136 accum_step_q
// (transfer_dtype='int8'): int8 x int8 summed EXACTLY in int32, then
// `c + scale * f32(out)` with scale = alpha * s_a * s_b.  The int32 sum is
// exact for any order while 127^2 * K < 2^31, i.e. K <= 131072 (2^17, every
// gemm_blk_size the pipeline uses); a larger K is refused.  The epilogue
// rounds twice, __fadd_rn(c, __fmul_rn(scale, float(acc))), as XLA's
// multiply then add do, so the plain version can match it bit for bit.
// Its int32 output ('s8' into an int32 C, bof_tpu/parallel/mesh.py:109
// sharded_accum_step_q's per-device partial) stores C += the exact int32
// sum with no rescale, so the partials of several cards can be summed
// exactly before the one rescale: the same kernel body, only the
// epilogue's type and arithmetic differ.
//
// Layouts are K1's eight storage-major ones: A (M,K) or (K,M)
// with a_km, B (K,N) or (N,K) with b_nk, C (M,N) or (N,M) with c_nm.
//
// What bounds it: at the pipeline's superblock (8192^3) a step is 1.10e12
// operations; the H100's dense tensor cores do 989 TFLOP/s in bf16 and
// 1,979 TOPS in int8, i.e. 1.112 ms and 0.556 ms, against 0.81 / 0.67 GB of
// traffic (A and B read once, C read and written: 0.24 / 0.20 ms at
// 3.35 TB/s).  So both are bound by tensor-core operations, and only wgmma
// reaches the tensor cores' full rate.
//
// How the design meets it: one kernel body (accum_lowp_kernel) serves both
// types; only the wgmma instruction, the accumulator type and the epilogue
// differ.
// - wgmma takes int8 operands only K-major, so both types read only K-major
//   operands, through TMA.  A pack pass (pack_kernel) first writes a K-major
//   copy of each operand whose storage is not K-major (a_km, or B stored
//   (K,N)) or that TMA cannot describe where it lies (a base not 16-byte
//   aligned, rows not a multiple of 16 bytes apart) into a workspace whose
//   rows are K rounded up to 16 bytes; ops/matmul_cuda.py:lowp_packs says
//   which.  It reads the operand once and writes it once, 32-bit words on
//   both sides of a shared-memory transpose: 128 MiB at 8192^2 int8, at
//   least 0.04 ms at 3.35 TB/s.
// - A ring of 4 shared-memory stages (192 KiB), each 128 bytes of K (64
//   bf16 or 128 int8) of a 128 x 256 block tile, filled by TMA with the
//   128-byte swizzle, an mbarrier a stage counting the bytes in.  Two
//   warpgroups each own 64 rows and issue wgmma m64n256k16 (bf16 -> f32) or
//   m64n256k32 (s8 -> s32) on them, 128 accumulators a thread, one stage's
//   group in flight while the next stage is awaited.  Whichever of the two
//   finishes with a stage last refills it, so no warp is spent on loading
//   alone (matmul_tf32.cu's scheme).  ptxas notes (C7517) that it retires
//   the group in flight before the stage wait's watchdog trap; on an H100
//   a wait without the trap measured the same (PERF.md), so the watchdog
//   stays.
// - Ragged M/N/K edges: TMA fills out-of-bounds boxes with zeros, which
//   adds nothing in either type, and the epilogue masks its stores.  c_nm
//   is the transposed product C^T += op(B)^T op(A)^T, formed by swapping
//   the two K-major operands.
// - Epilogue: C += alpha * acc straight from the accumulator fragment, so
//   a step reads C once and writes it once; a thread loads a batch of its
//   C elements before it stores any (see the epilogue), in 8-byte pairs.
// - Tiles are visited in groups of 16 block rows, so one wave of blocks
//   shares its A and B tiles in L2.
// - The tensor cores' fp32 accumulation drops low bits (measured for tf32,
//   matmul_tf32.cu).  For one bf16 pass what that leaves is far inside the
//   fp32 tolerance at 8192^3 (chip_smoke.py checks it), so 'bf16'
//   accumulates on the tensor cores; s8's int32 sum is exact.

#include <cuda.h>  // CUtensorMap and the driver API's types; not linked
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;          // block tile rows: 2 consumer warpgroups x 64
constexpr int BN = 256;          // block tile columns: wgmma n256
constexpr int KB = 128;          // bytes of K a stage: one swizzled row
constexpr int WK = 32;           // bytes of K of one wgmma (k16 bf16, k32 s8)
constexpr int GROUP_M = 16;      // block rows per raster group (L2 reuse)
constexpr int WG = 128;          // threads in a warpgroup
constexpr int THREADS = 2 * WG;  // no producer warp (see the header note)
constexpr int TILE_P = BM * KB;  // bytes of one P (rows of C) tile
constexpr int TILE_Q = BN * KB;  // bytes of one Q (columns of C) tile
constexpr int STAGE_BYTES = TILE_P + TILE_Q;
constexpr int STAGES = 196608 / STAGE_BYTES;  // 192 KiB of tiles: 4
// stages, then an mbarrier and a counter a stage, plus slack to align the
// base to 1 KiB (the 128-byte swizzle's atom is 8 rows of 128 bytes)
constexpr int SMEM = STAGES * STAGE_BYTES + STAGES * 12 + 1024;
constexpr int PACK_TILE = 64;    // pack pass: 64 x 64 elements a block
constexpr int EPI_CHUNKS = 8;    // epilogue: 8-column chunks loaded at once

static_assert(STAGE_BYTES % 1024 == 0 && (64 * KB) % 1024 == 0,
              "every tile a wgmma descriptor points at starts on a 1 KiB "
              "swizzle atom");

enum Kind { BF16 = 0, S8 = 1 };

template <int KIND>
struct Traits;
template <>
struct Traits<BF16> {
  using Elem = uint16_t;  // bf16 bits: the pack pass only moves them
  using Acc = float;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Traits<S8> {
  using Elem = uint8_t;
  using Acc = int;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// ------------------------------------------------------------------ wgmma

#define ACC_REGS                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
  "%127"

// the 128 accumulator operands of one m64n256 wgmma, constraint C
#define ACC_OPS(C, d)                                                      \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
  C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),     \
  C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]),   \
  C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]),   \
  C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]),   \
  C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]),   \
  C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]),   \
  C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]),   \
  C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63]),   \
  C(d[64]), C(d[65]), C(d[66]), C(d[67]), C(d[68]), C(d[69]), C(d[70]),   \
  C(d[71]), C(d[72]), C(d[73]), C(d[74]), C(d[75]), C(d[76]), C(d[77]),   \
  C(d[78]), C(d[79]), C(d[80]), C(d[81]), C(d[82]), C(d[83]), C(d[84]),   \
  C(d[85]), C(d[86]), C(d[87]), C(d[88]), C(d[89]), C(d[90]), C(d[91]),   \
  C(d[92]), C(d[93]), C(d[94]), C(d[95]), C(d[96]), C(d[97]), C(d[98]),   \
  C(d[99]), C(d[100]), C(d[101]), C(d[102]), C(d[103]), C(d[104]),        \
  C(d[105]), C(d[106]), C(d[107]), C(d[108]), C(d[109]), C(d[110]),       \
  C(d[111]), C(d[112]), C(d[113]), C(d[114]), C(d[115]), C(d[116]),       \
  C(d[117]), C(d[118]), C(d[119]), C(d[120]), C(d[121]), C(d[122]),       \
  C(d[123]), C(d[124]), C(d[125]), C(d[126]), C(d[127])

// d += A(64 x 16 bf16, K-major, desc a) * B(16 x 256, K-major, desc b), fp32
// accumulate, for the executing warpgroup.
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" ACC_REGS
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC_OPS("+f", d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A(64 x 32 int8) * B(32 x 256 int8), both K-major, int32 accumulate
// (exact), for the executing warpgroup.
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" ACC_REGS
      "}, %128, %129, p;\n"
      "}\n"
      : ACC_OPS("+r", d)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ float epilogue(float alpha, float acc, float c) {
  return fmaf(alpha, acc, c);
}

__device__ __forceinline__ float epilogue(float scale, int acc, float c) {
  return __fadd_rn(c, __fmul_rn(scale, __int2float_rn(acc)));
}

// the int32 output: C += acc, exact while the sum fits in int32
__device__ __forceinline__ int epilogue(float, int acc, int c) {
  return c + acc;
}

// one thread's two adjacent C elements, as one 8-byte access
template <typename Out>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<int> {
  using type = int2;
};

// --------------------------------------------------------------- kernels

// The pack pass for one operand of `rows` x K logical elements (rows of C
// or columns of C, K inner): reads it in storage order (TRANS: stored
// (K, rows); else (rows, K), copied only because TMA cannot read it where
// it lies) and writes a K-major copy with leading dimension ldo (a
// multiple of 16 bytes, 16-byte aligned).  64 x 64 element tiles, 1-D
// grid.  A transpose moves 32-bit words of V elements: a warp reads
// consecutive words of a stored row (where `vec`: the source's base and
// rows 4-byte aligned) into a shared tile [k][r], then gathers V K-adjacent
// elements of a row into each word it writes, consecutive words across the
// warp.  The padded pitch keeps the gathers to 2-way bank conflicts.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(256)
pack_kernel(const T* __restrict__ src, long long lds, T* __restrict__ dst,
            long long ldo, int rows, int K, bool vec) {
  constexpr int V = 4 / sizeof(T);         // elements a 32-bit word
  constexpr int W = PACK_TILE / V;         // words a tile row
  constexpr int PITCH = PACK_TILE + V;     // elements a shared row
  __shared__ __align__(4) T tile[PACK_TILE][PITCH];
  const int ktiles = (K + PACK_TILE - 1) / PACK_TILE;
  const int r0 = (blockIdx.x / ktiles) * PACK_TILE;
  const int k0 = (blockIdx.x % ktiles) * PACK_TILE;
  if (!TRANS) {  // a K-major operand TMA cannot read in place: copy it
    for (int i = threadIdx.x; i < PACK_TILE * PACK_TILE; i += 256) {
      const int r = r0 + i / PACK_TILE, k = k0 + i % PACK_TILE;
      if (r < rows && k < K)
        dst[(long long)r * ldo + k] = src[(long long)r * lds + k];
    }
    return;
  }
  for (int i = threadIdx.x; i < PACK_TILE * W; i += 256) {  // tile[k][r]
    const int kk = i / W, rr = V * (i % W);
    const int k = k0 + kk, r = r0 + rr;
    const T* s = src + (long long)k * lds + r;
    uint32_t word = 0;
    if (k < K && vec && r + V <= rows) {
      word = *reinterpret_cast<const uint32_t*>(s);
    } else if (k < K) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (r + e < rows)
          word |= static_cast<uint32_t>(s[e]) << (8 * sizeof(T) * e);
    }
    *reinterpret_cast<uint32_t*>(&tile[kk][rr]) = word;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < PACK_TILE * W; i += 256) {
    const int rr = i / W, kk = V * (i % W);
    const int r = r0 + rr, k = k0 + kk;
    if (r >= rows) continue;
    T* o = dst + (long long)r * ldo + k;
    if (k + V <= K) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < V; ++e)
        word |= static_cast<uint32_t>(tile[kk + e][rr]) << (8 * sizeof(T) * e);
      *reinterpret_cast<uint32_t*>(o) = word;
    } else {
      for (int e = 0; e < V && k + e < K; ++e) o[e] = tile[kk + e][rr];
    }
  }
}

// D (M x N, row-major, ldd) += alpha * P Q^T, where P (M x K) and Q (N x K)
// are K-major and read through tensor maps in KIND's element type; D is
// fp32, or int32 for S8's exact sum (alpha unused).
template <int KIND, typename Out>
__global__ void __launch_bounds__(THREADS, 1)
accum_lowp_kernel(const __grid_constant__ CUtensorMap p_map,
                  const __grid_constant__ CUtensorMap q_map,
                  Out* __restrict__ d, long long ldd, float alpha, int M,
                  int N, int K) {
  using Acc = typename Traits<KIND>::Acc;
  constexpr int KE = KB / sizeof(typename Traits<KIND>::Elem);  // K a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // mbarriers
  // per stage, how many warpgroups have finished reading it (mod 2)
  uint32_t* done =
      reinterpret_cast<uint32_t*>(smem + STAGES * STAGE_BYTES + 8 * STAGES);

  // grouped raster: GROUP_M block rows, block rows fastest within a group
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int group = blockIdx.x / (GROUP_M * tiles_n);
  const int first_m = group * GROUP_M;
  const int group_m = min(GROUP_M, tiles_m - first_m);
  const int in_group = blockIdx.x % (GROUP_M * tiles_n);
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int ktiles = (K + KE - 1) / KE;
  const int wg = threadIdx.x / WG;

  // K-tile kt of both operands into its stage, reported to the stage's
  // barrier as bytes (a box past an edge still counts in full)
  auto load = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t stage = ring + s * STAGE_BYTES, bar = full + 8 * s;
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(stage, &p_map, bar, kt * KE, m0);
    tma_load(stage + TILE_P, &q_map, bar, kt * KE, n0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);  // the loader's expect_tx arrival
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kt = 0; kt < min(STAGES, ktiles); ++kt) load(kt);
  }
  __syncthreads();

  // One thread of each warpgroup calls this once the warpgroup's wgmmas no
  // longer read K-tile kt's stage; the second of the two refills the stage
  // with K-tile kt + STAGES.
  auto release = [&](int kt) {
    const int s = kt % STAGES;
    __threadfence_block();
    if (atomicAdd(&done[s], 1u) % 2 == 1 && kt + STAGES < ktiles)
      load(kt + STAGES);
  };

  // warpgroup wg owns rows wg*64 .. wg*64+63 of the block tile
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
  const uint32_t p_off = wg * 64 * KB;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t stage = ring + s * STAGE_BYTES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint64_t pd = smem_desc<KB>(stage + p_off);
    const uint64_t qd = smem_desc<KB>(stage + TILE_P);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / WK; ++kk) {
      const uint64_t step = (kk * WK) >> 4;  // 16-byte units
      wgmma(acc, pd + step, qd + step);
    }
    wgmma_commit();
    // keep this stage's group in flight; the previous one is done, so its
    // stage can be refilled.  Nothing may touch acc between the commit and
    // this wait: ptxas would then wait for the group at once (C7517).
    wgmma_wait<1>();
    fence_acc(acc);
    if (kt > 0 && threadIdx.x % WG == 0) release(kt - 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: the m64nNk* fragment holds, for 8-column chunk j,
  // acc[4j + 2i + e] at row warp*16 + lane/4 + 8i, column 8j + 2(lane%4) + e.
  // A batch of EPI_CHUNKS chunks of C is loaded before any of it is
  // stored: with a store between every two loads, each element would wait
  // a full trip to memory (the compiler may not move a load above a store
  // through the same pointer), which cost 2.2 ms of 's8''s 2.9 at 8192^3.
  const int t = threadIdx.x % WG;
  const int row0 = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
  // a thread's two columns of a chunk are adjacent: one 8-byte access
  // where C's rows and base allow it
  const bool pairs =
      ldd % 2 == 0 && reinterpret_cast<uintptr_t>(d) % 8 == 0;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_CHUNKS) {
    using P2 = typename Pair<Out>::type;
    Out cv[2][EPI_CHUNKS][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const Out* drow = d + (long long)min(row, M - 1) * ldd;
#pragma unroll
      for (int jj = 0; jj < EPI_CHUNKS; ++jj) {
        const int col = col0 + 8 * (j0 + jj);
        if (row < M && pairs && col + 1 < N) {
          const P2 v = *reinterpret_cast<const P2*>(drow + col);
          cv[i][jj][0] = v.x;
          cv[i][jj][1] = v.y;
        } else {
          cv[i][jj][0] = row < M && col < N ? drow[col] : Out(0);
          cv[i][jj][1] = row < M && col + 1 < N ? drow[col + 1] : Out(0);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= M) continue;
      Out* drow = d + (long long)row * ldd;
#pragma unroll
      for (int jj = 0; jj < EPI_CHUNKS; ++jj) {
        const int j = j0 + jj, col = col0 + 8 * j;
        const Out v0 = epilogue(alpha, acc[4 * j + 2 * i], cv[i][jj][0]);
        const Out v1 = epilogue(alpha, acc[4 * j + 2 * i + 1], cv[i][jj][1]);
        if (pairs && col + 1 < N) {
          P2 v;
          v.x = v0;
          v.y = v1;
          *reinterpret_cast<P2*>(drow + col) = v;
        } else {
          if (col < N) drow[col] = v0;
          if (col + 1 < N) drow[col + 1] = v1;
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

// One operand of `rows` x K as the product reads it: K-major, at *x with
// leading dimension *ld.  With a workspace the pack pass writes it there
// (transposing when its storage is not K-major); without one its storage
// must be K-major and readable by TMA.  Returns false when it is not.
template <typename T>
bool prepare(const void* src, long long lds, bool kmajor, int rows, int K,
             void* ws, long long ldw, const void** x, long long* ld,
             cudaStream_t s) {
  if (ws == nullptr) {
    if (!kmajor || !tma_ok(src, lds, sizeof(T))) return false;
    *x = src;
    *ld = lds;
    return true;
  }
  if (ldw < K || !tma_ok(ws, ldw, sizeof(T))) return false;
  const long long blocks = (long long)((rows + PACK_TILE - 1) / PACK_TILE) *
                           ((K + PACK_TILE - 1) / PACK_TILE);
  const T* in = static_cast<const T*>(src);
  T* out = static_cast<T*>(ws);
  const bool vec = reinterpret_cast<uintptr_t>(src) % 4 == 0 &&
                   (lds * sizeof(T)) % 4 == 0;
  if (kmajor)
    pack_kernel<T, false><<<(unsigned)blocks, 256, 0, s>>>(in, lds, out, ldw,
                                                           rows, K, vec);
  else
    pack_kernel<T, true><<<(unsigned)blocks, 256, 0, s>>>(in, lds, out, ldw,
                                                          rows, K, vec);
  *x = ws;
  *ld = ldw;
  return true;
}

// Tensor map of a K-major (rows x K) operand with leading dimension ld
// elements, cut into boxes of box_rows x 128 bytes of K with the 128-byte
// swizzle; out-of-bounds elements of a box read as zero.
template <int KIND>
bool kmajor_map(CUtensorMap* map, const void* base, int rows, int K,
                long long ld, int box_rows) {
  constexpr int SIZE = sizeof(typename Traits<KIND>::Elem);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * SIZE};
  const cuuint32_t box[2] = {KB / SIZE, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, Traits<KIND>::TMA_TYPE, 2, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KIND, typename Out>
int launch(Out* c, const void* a, const void* b, float alpha, int M, int N,
           int K, bool a_kmajor, bool b_kmajor, bool c_nm, long long lda,
           long long ldb, long long ldc, void* a_ws, void* b_ws,
           long long ldw, cudaStream_t s) {
  using T = typename Traits<KIND>::Elem;
  // P = op(A) (M x K) and Q = op(B)^T (N x K), both K-major
  const void *p, *q;
  long long ldp, ldq;
  if (!prepare<T>(a, lda, a_kmajor, M, K, a_ws, ldw, &p, &ldp, s) ||
      !prepare<T>(b, ldb, b_kmajor, N, K, b_ws, ldw, &q, &ldq, s))
    return static_cast<int>(cudaErrorInvalidValue);
  int rows_p = M, rows_q = N;
  if (c_nm) {  // C^T (N x M) += op(B)^T op(A)^T: swap the two operands
    const void* t = p; p = q; q = t;
    const long long u = ldp; ldp = ldq; ldq = u;
    rows_p = N;
    rows_q = M;
  }
  CUtensorMap pm, qm;
  if (!kmajor_map<KIND>(&pm, p, rows_p, K, ldp, BM) ||
      !kmajor_map<KIND>(&qm, q, rows_q, K, ldq, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      accum_lowp_kernel<KIND, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long tiles =
      (long long)((rows_p + BM - 1) / BM) * ((rows_q + BN - 1) / BN);
  accum_lowp_kernel<KIND, Out><<<(unsigned)tiles, THREADS, SMEM, s>>>(
      pm, qm, c, ldc, alpha, rows_p, rows_q, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C_storage += alpha * op(A) op(B) with A and B bf16 (kind 0) or int8
// (kind 1), launched on `stream` (a cudaStream_t); lda/ldb/ldc are the
// storage leading dimensions in elements.  For int8 alpha is the scale
// alpha * s_a * s_b and K may be at most 131072 (the int32 sum is exact up
// to there).  a_ws (M rows) and b_ws (N rows), each with leading dimension
// ldw elements (>= K, a multiple of 16 bytes), are the pack pass's
// workspaces, allocated by the caller: an operand with a workspace is
// packed K-major into it first; one without must be K-major (A stored
// (M,K), B stored (N,K)) with a 16-byte aligned base and rows.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// argument it refuses (a kind, a K, an operand it cannot read, a tensor
// map the driver refuses): 0 when accepted.
extern "C" int bof_accum_matmul_lowp(float* c, const void* a, const void* b,
                                     float alpha, int M, int N, int K,
                                     int a_km, int b_nk, int c_nm,
                                     long long lda, long long ldb,
                                     long long ldc, int kind, void* a_ws,
                                     void* b_ws, long long ldw, void* stream) {
  if (kind != BF16 && kind != S8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == S8 && K > (1 << 17))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0) return 0;  // nothing to add
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A (M,K) row-major is K-major; B is K-major when stored (N,K)
  const bool a_kmajor = !a_km, b_kmajor = b_nk != 0;
  return kind == BF16
             ? launch<BF16>(c, a, b, alpha, M, N, K, a_kmajor, b_kmajor,
                            c_nm != 0, lda, ldb, ldc, a_ws, b_ws, ldw, s)
             : launch<S8>(c, a, b, alpha, M, N, K, a_kmajor, b_kmajor,
                          c_nm != 0, lda, ldb, ldc, a_ws, b_ws, ldw, s);
}

// 's8' with an int32 C: C_storage += op(A) op(B), the int8 products summed
// exactly in int32 and added to C in int32 (exact while the result fits).
// Arguments as bof_accum_matmul_lowp's, without alpha and kind.
extern "C" int bof_accum_matmul_s8_i32(int* c, const void* a, const void* b,
                                       int M, int N, int K, int a_km,
                                       int b_nk, int c_nm, long long lda,
                                       long long ldb, long long ldc,
                                       void* a_ws, void* b_ws, long long ldw,
                                       void* stream) {
  if (K > (1 << 17)) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0) return 0;  // nothing to add
  return launch<S8>(c, a, b, 1.f, M, N, K, !a_km, b_nk != 0, c_nm != 0, lda,
                    ldb, ldc, a_ws, b_ws, ldw,
                    static_cast<cudaStream_t>(stream));
}
