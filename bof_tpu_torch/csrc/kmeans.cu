// B7: the fused Lloyd block step of out-of-core k-means, in two kernels.
//
// Replaces bof_tpu/ops/kmeans.py:40 lloyd_block (built by _jit_steps :32), an
// XLA step that computes G = P C^T, pd = |c|^2 - 2G, a row argmin and min,
// and the center sums and counts as a one-hot matmul.
//
// lloyd_assign: for each point p_i of a block P (bn, d) fp32 row-major and
//   the centers C (k, d) fp32 row-major with their squared norms cn (k),
//   labels[i] = argmin_j (cn_j - 2 p_i . c_j) (the first index on a tie, as
//   jnp.argmin) and mind[i] = that minimum.  |p_i|^2 is constant per point
//   and left out, as in bof_tpu.
// lloyd_accumulate: sums[j] += sum of the points labelled j and counts[j] +=
//   their number, sums fp32 (k, d), counts int32 (exact).
//
// What bounds lloyd_assign: G is 2 * bn * k * d operations, and the design
// below computes it in three TF32 passes; at the streamed block of S11 (bn
// 131072, d 128, k 1024) that is 3 * 34.4 GFLOP on 65 MB of points and
// centers, 0.208 ms at the H100's 495 TFLOP/s against 0.02 ms for the
// bytes, so tensor-core operations bound it.  The point of a hand kernel is
// what it does not write: the (bn x k) distance block (512 MiB at S11)
// never leaves registers.
//
// Design: K1's 3xTF32 mainloop (matmul_tf32.cu) with an argmin epilogue.
// - P and C are both K-major (rows of d floats), as wgmma reads tf32.  The
//   split pass (hopper.cuh: tf32_prepare) writes lo = x - tf32(x) of each
//   (P's: 64 MiB at S11, about 0.04 ms of traffic), and a K-major copy at a
//   leading dimension of d rounded up to 32 floats (rows on 128-byte lines)
//   when TMA cannot read the operand where it lies (d % 4 != 0, or a base
//   not 16-byte aligned); the tensor maps' K extent is d, so the copy's
//   padding reads as zeros.
// - A block owns 128 points (two consumer warpgroups of 64 rows) and walks
//   every center in tiles of 256.  One TMA ring of two 96 KiB stages (P's
//   hi and lo 32-float K slices and the center tile's, 128-byte swizzle)
//   runs through the (center tile, K slice) sequence without a break
//   between tiles; the warpgroup that finishes with a stage second refills
//   it, so no warp only loads.  P's slices are read again for each center
//   tile, from L2.
// - Each stage's three tf32 products go into a fresh accumulator that is
//   added to fp32 registers (hopper.cuh: tf32x3_stage): fp32-class
//   arithmetic at every matmul_precision, at least each of bof_tpu's tiers.
//   32 floats of K a stage halve those adds against K1's 16 (12 % faster
//   at S11's block, PERF.md).
// - A tile's fp32 accumulators start at -cn/2 of their center, so the
//   tile ends at g - cn/2 = -pd/2 (pd rounded along the sums, not once at
//   the end; well inside the fp32 tolerance), and the epilogue folds the
//   64 x 256 fragment into a running (max, argmax) for each of the
//   thread's 2 rows with compares alone, centers in increasing index
//   order (a tie keeps the first); centers past k are skipped.  Loading
//   cn and forming pd in the fold instead cost 11 % of the kernel's time
//   (PERF.md).  After the last tile, pd = -2 * that max exactly, and
//   the 4 lanes that share a row reduce with shuffles, the smaller index
//   winning a tie.  No atomics: two runs give the same bits.
//
// What bounds lloyd_accumulate: reading P once (bn * d * 4 bytes), the
// labels once and sums and counts once each way, 0.02 ms at S11.  Design:
// a deterministic counting sort of the labels, then per-center sums, in
// five launches that read the labels once (scratch from the wrapper):
//   1. per-chunk histograms of 1024 labels (shared-memory atomics for k up
//      to SHARED_K, global ones past it; integer counts are order-free);
//   2. a scan over chunks a center (a warp each) and one over centers (one
//      block), which gives each center its range of a sorted index array
//      and each (chunk, center) its start in it; counts += the totals;
//   3. a stable scatter: a warp a chunk writes its point indices into their
//      ranges in index order (__match_any_sync ranks equal labels by lane);
//   4. a block a center sums its own rows: each thread one feature, in
//      index order, into an fp32 register from 0, then adds that block sum
//      to the running sum once (as bof_tpu adds each block's one-hot
//      product).
// No float atomics, so two runs (and the resident and streamed tiers) give
// the same bits, and a pass over 2^24 points adds 128 block sums a center
// instead of 16384 points into one fp32 sum.  The order of additions is
// the first design's (one block a center scanning every label, k passes
// over the labels), so the sums keep its bits.  All points in one center
// leave a single block to sum every row: correct, but one SM's loads.

#include <cuda.h>  // CUtensorMap and the driver API's types; not linked
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int A_BM = 128;            // points a block: 2 warpgroups x 64
constexpr int A_BN = 256;            // centers a tile
constexpr int A_NH = A_BN / 128;     // 128-center parts of a tile
constexpr int A_BK = 32;             // fp32 of K a stage: one 128-byte row
constexpr int A_WG = 128;            // threads in a warpgroup
constexpr int A_THREADS = 2 * A_WG;  // no producer warp, as in K1
constexpr int A_TILE_P = A_BM * A_BK * 4;  // bytes of a P slice
constexpr int A_TILE_C = A_BN * A_BK * 4;  // bytes of a center slice
constexpr int A_STAGE = 2 * (A_TILE_P + A_TILE_C);  // hi and lo of both
constexpr int A_STAGES = 196608 / A_STAGE;          // 192 KiB of tiles
// stages, then an mbarrier and a counter a stage, plus slack to align the
// base to 1 KiB (the 128-byte swizzle's atom is 8 rows of 128 bytes)
constexpr int A_SMEM = A_STAGES * A_STAGE + A_STAGES * 12 + 1024;

static_assert(A_BN % 128 == 0, "the products go 128 centers at a time");

__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v < bv || (v == bv && j < bj);
}

// Step t of the (center tile, K slice) sequence into its stage of the ring,
// reported to the stage's full barrier as bytes.
__device__ __forceinline__ void assign_load(
    int t, int ktiles, uint32_t ring, uint32_t full, const CUtensorMap* p_x,
    const CUtensorMap* c_x, const CUtensorMap* p_lo, const CUtensorMap* c_lo,
    int m0) {
  const int s = t % A_STAGES;
  const int n0 = (t / ktiles) * A_BN, k0 = (t % ktiles) * A_BK;
  const uint32_t stage = ring + s * A_STAGE, bar = full + 8 * s;
  mbar_expect_tx(bar, A_STAGE);
  tma_load(stage, p_x, bar, k0, m0);
  tma_load(stage + A_TILE_P, c_x, bar, k0, n0);
  tma_load(stage + A_TILE_P + A_TILE_C, p_lo, bar, k0, m0);
  tma_load(stage + 2 * A_TILE_P + A_TILE_C, c_lo, bar, k0, n0);
}

// labels/mind of the block's 128 points against all k centers; p_x/c_x are
// the points and centers (TF32 hi by truncation), p_lo/c_lo their lo parts,
// all K-major with K extent d.
__global__ void __launch_bounds__(A_THREADS, 1)
lloyd_assign_kernel(const __grid_constant__ CUtensorMap p_x,
                    const __grid_constant__ CUtensorMap c_x,
                    const __grid_constant__ CUtensorMap p_lo,
                    const __grid_constant__ CUtensorMap c_lo,
                    const float* __restrict__ cn, int* __restrict__ labels,
                    float* __restrict__ mind, int bn, int k, int d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + A_STAGES * A_STAGE;  // mbarriers
  // per stage, how many warpgroups have finished reading it (mod 2)
  uint32_t* done =
      reinterpret_cast<uint32_t*>(smem + A_STAGES * A_STAGE + 8 * A_STAGES);

  const int m0 = blockIdx.x * A_BM;
  const int ktiles = (d + A_BK - 1) / A_BK;
  const int steps = ((k + A_BN - 1) / A_BN) * ktiles;
  const int wg = threadIdx.x / A_WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);  // the loader's expect_tx arrival
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < min(A_STAGES, steps); ++t)
      assign_load(t, ktiles, ring, full, &p_x, &c_x, &p_lo, &c_lo, m0);
  }
  __syncthreads();

  // One thread of each warpgroup calls this once the warpgroup's wgmmas no
  // longer read step t's stage; the second of the two refills the stage
  // with step t + A_STAGES.
  auto release = [&](int t) {
    const int s = t % A_STAGES;
    __threadfence_block();
    if (atomicAdd(&done[s], 1u) % 2 == 1 && t + A_STAGES < steps)
      assign_load(t + A_STAGES, ktiles, ring, full, &p_x, &c_x, &p_lo, &c_lo,
                  m0);
  };

  // the m64nNk8 fp32 fragment holds, for 8-column chunk j, acc[4j + 2i + e]
  // at row warp*16 + lane/4 + 8i, column 8j + 2(lane%4) + e
  const int wt = threadIdx.x % A_WG;  // thread within the warpgroup
  const int quad = wt % 4;
  // the thread's best of each of its 2 rows so far: the largest -pd/2 and
  // its center
  float best_a[2];
  int best_j[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    best_a[i] = __int_as_float(0xff800000);  // -inf
    best_j[i] = 0;
  }

  const uint32_t p_off = wg * 64 * A_BK * 4;  // this warpgroup's rows
  int t = 0;
  for (int n0 = 0; n0 < k; n0 += A_BN) {
    // acc starts at -cn/2 of its center, so the tile ends at g - cn/2 =
    // -pd/2 and the fold only compares
    float acc[A_BN / 2];
#pragma unroll
    for (int j = 0; j < A_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * quad + e;
        const float h = col < k ? -0.5f * __ldg(cn + col) : 0.f;
        acc[4 * j + e] = h;
        acc[4 * j + 2 + e] = h;
      }
    }
    for (int kt = 0; kt < ktiles; ++kt, ++t) {
      const int s = t % A_STAGES;
      const uint32_t stage = ring + s * A_STAGE;
      mbar_wait(full + 8 * s, (t / A_STAGES) & 1);
      tf32x3_stage<A_NH, A_BK>(
          acc, tf32_desc<A_BK>(stage + p_off),
          tf32_desc<A_BK>(stage + A_TILE_P),
          tf32_desc<A_BK>(stage + A_TILE_P + A_TILE_C + p_off),
          tf32_desc<A_BK>(stage + 2 * A_TILE_P + A_TILE_C));
      if (wt == 0) release(t);
    }
    // fold this tile into the running (max, argmax) of -pd/2, the thread's
    // centers in increasing index order (a tie keeps the first)
#pragma unroll
    for (int j = 0; j < A_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * quad + e;
        if (col < k) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (acc[4 * j + 2 * i + e] > best_a[i]) {
              best_a[i] = acc[4 * j + 2 * i + e];
              best_j[i] = col;
            }
          }
        }
      }
    }
  }

  // the 4 lanes of a quad share a row; pd = -2 * acc exactly
  float best_v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    best_v[i] = -2.f * best_a[i];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best_v[i], off);
      const int j = __shfl_xor_sync(0xffffffffu, best_j[i], off);
      if (better(v, j, best_v[i], best_j[i])) {
        best_v[i] = v;
        best_j[i] = j;
      }
    }
    const int row = m0 + wg * 64 + (wt / 32) * 16 + (wt % 32) / 4 + 8 * i;
    if (quad == 0 && row < bn) {
      labels[row] = best_j[i];
      mind[row] = best_v[i];
    }
  }
}

// lloyd_accumulate as a deterministic counting sort of the labels, then
// per-center sums.  Labels come in chunks of ACC_CHUNK; `hist` is a
// (k x nchunks) int32 table, center-major.
constexpr int ACC_CHUNK = 1024;        // labels a chunk (one warp scatters it)
constexpr int ACC_STEPS = ACC_CHUNK / 32;
constexpr int HIST_THREADS = 256;
constexpr int SHARED_K = 4096;         // centers a shared-memory table holds
constexpr int SCAN_WARPS = 8;          // centers a block of the chunk scan
constexpr int OFF_THREADS = 1024;
constexpr int SUM_THREADS = 128;       // features a pass

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// 1. hist[j][c] = the number of chunk c's labels equal to j.  For k up to
// SHARED_K a block counts in shared memory and writes its whole column;
// past that it adds into the table (zeroed by the host entry) with global
// atomics.  Integer counts are exact in any order.
__global__ void __launch_bounds__(HIST_THREADS)
acc_hist_kernel(const int* __restrict__ labels, int* __restrict__ hist,
                int bn, int k, int nchunks) {
  __shared__ int h[SHARED_K];
  const int c = blockIdx.x;
  const int i0 = c * ACC_CHUNK, i1 = min(bn, i0 + ACC_CHUNK);
  if (k <= SHARED_K) {
    for (int j = threadIdx.x; j < k; j += HIST_THREADS) h[j] = 0;
    __syncthreads();
    for (int i = i0 + threadIdx.x; i < i1; i += HIST_THREADS)
      atomicAdd(&h[labels[i]], 1);
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += HIST_THREADS)
      hist[(long long)j * nchunks + c] = h[j];
  } else {
    for (int i = i0 + threadIdx.x; i < i1; i += HIST_THREADS)
      atomicAdd(&hist[(long long)labels[i] * nchunks + c], 1);
  }
}

// 2a. A warp a center: hist[j][c] becomes the exclusive prefix over chunks
// (where chunk c's points of center j start within j's range), tot[j] the
// center's count.
__global__ void __launch_bounds__(SCAN_WARPS * 32)
acc_scan_kernel(int* __restrict__ hist, int* __restrict__ tot, int k,
                int nchunks) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * SCAN_WARPS + threadIdx.x / 32;
  if (j >= k) return;
  int* row = hist + (long long)j * nchunks;
  int run = 0;
#pragma unroll 4
  for (int c0 = 0; c0 < nchunks; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < nchunks ? row[c] : 0;
    const int incl = warp_inclusive_scan(v, lane);
    if (c < nchunks) row[c] = run + incl - v;
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tot[j] = run;
}

// 2b. One block: off[j] = sum of tot[j'] for j' < j (where center j's range
// starts), and counts[j] += tot[j].
__global__ void __launch_bounds__(OFF_THREADS)
acc_offsets_kernel(const int* __restrict__ tot, int* __restrict__ off,
                   int* __restrict__ counts, int k) {
  __shared__ int warp_sum[OFF_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int carry = 0;  // the sum of every earlier round, the same in each thread
  for (int j0 = 0; j0 < k; j0 += OFF_THREADS) {
    const int j = j0 + threadIdx.x;
    const int v = j < k ? tot[j] : 0;
    const int incl = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_sum[lane] = warp_inclusive_scan(warp_sum[lane], lane);
    __syncthreads();
    if (j < k) {
      off[j] = carry + (warp ? warp_sum[warp - 1] : 0) + incl - v;
      counts[j] += v;
    }
    carry += warp_sum[OFF_THREADS / 32 - 1];
    __syncthreads();  // warp_sum is rewritten next round
  }
}

// 3. A warp a chunk writes the chunk's point indices into their centers'
// ranges of `order`, in index order: 32 labels a step, ranked among equal
// labels by lane (__match_any_sync), after the chunk's earlier steps.  For
// k up to SHARED_K each lane loads the start of its 32 labels' (center,
// chunk) slots up front and shared memory counts the chunk's points placed
// a center; past that the chunk's own column of hist, which no other warp
// touches, holds the running position.
__global__ void __launch_bounds__(32)
acc_scatter_kernel(const int* __restrict__ labels, int* hist,
                   const int* __restrict__ off, int* __restrict__ order,
                   int bn, int k, int nchunks) {
  extern __shared__ int placed[];  // k entries when k <= SHARED_K
  const int c = blockIdx.x, lane = threadIdx.x;
  const bool in_shared = k <= SHARED_K;
  if (in_shared)
    for (int j = lane; j < k; j += 32) placed[j] = 0;
  const int i0 = c * ACC_CHUNK;
  int lab[ACC_STEPS], start[ACC_STEPS];
#pragma unroll
  for (int s = 0; s < ACC_STEPS; ++s) {
    const int i = i0 + s * 32 + lane;
    lab[s] = i < bn ? labels[i] : -1;  // -1 matches no label
  }
#pragma unroll
  for (int s = 0; s < ACC_STEPS; ++s)
    start[s] = in_shared && lab[s] >= 0
                   ? off[lab[s]] + hist[(long long)lab[s] * nchunks + c]
                   : 0;
  __syncwarp();
  volatile int* col = hist + c;  // entry j at col[j * nchunks]
#pragma unroll
  for (int s = 0; s < ACC_STEPS; ++s) {
    const int j = lab[s];
    const unsigned peers = __match_any_sync(0xffffffffu, j);
    if (j >= 0) {
      const int at = in_shared ? start[s] + placed[j]
                               : off[j] + col[(long long)j * nchunks];
      order[at + __popc(peers & ((1u << lane) - 1))] = i0 + s * 32 + lane;
      __syncwarp(peers);
      if (lane == __ffs(peers) - 1) {
        if (in_shared)
          placed[j] += __popc(peers);
        else
          col[(long long)j * nchunks] = at - off[j] + __popc(peers);
      }
    }
    __syncwarp();
  }
}

// 4. A block a center: each thread sums one feature of the center's rows in
// index order into an fp32 register from 0, then adds that block sum to
// sums once (every center, an empty one too: sums += 0).  A warp loads 32
// row indices at once (the next 32 while this batch's rows are in flight)
// and each thread keeps 32 row loads in flight.
__global__ void __launch_bounds__(SUM_THREADS)
acc_sum_kernel(const float* __restrict__ p, const int* __restrict__ order,
               const int* __restrict__ off, const int* __restrict__ tot,
               float* __restrict__ sums, int d) {
  const int j = blockIdx.x, lane = threadIdx.x % 32;
  const int* rows = order + off[j];
  const int n = tot[j];
  for (int f0 = 0; f0 < d; f0 += SUM_THREADS) {
    const int f = f0 + threadIdx.x;
    const bool live = f < d;  // every lane stays for the shuffles
    float acc = 0.f;
    int next = lane < n ? rows[lane] : 0;
    for (int q = 0; q < n; q += 32) {
      const int mine = next, cnt = min(32, n - q);
      if (q + 32 + lane < n) next = rows[q + 32 + lane];
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int r = __shfl_sync(0xffffffffu, mine, u);
        v[u] = (live && u < cnt) ? p[(long long)r * d + f] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (u < cnt) acc += v[u];
    }
    if (live) sums[(long long)j * d + f] += acc;
  }
}

}  // namespace

// labels/mind of the bn points of p (bn, d) against the k centers cen
// (k, d) with squared norms cn (k), on `stream`.  The split pass's fp32
// workspaces, (rows x d) K-major at leading dimension ldw (a multiple of 4),
// come from the caller (ops/kmeans.py:lloyd_workspace): p_lo (bn rows) and
// c_lo (k rows) always, p_x and c_x (K-major copies) only where TMA cannot
// read the operand where it lies (d % 4 != 0, or a base not 16-byte
// aligned), else null.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a missing workspace or a tensor map the driver
// refuses.
extern "C" int bof_lloyd_assign(const float* p, const float* cen,
                                const float* cn, int* labels, float* mind,
                                float* p_x, float* p_lo, float* c_x,
                                float* c_lo, long long ldw, int bn, int k,
                                int d, void* stream) {
  if (bn <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *px, *cx;
  long long ldp, ldc;
  CUtensorMap pm, cm, plm, clm;
  if (!tf32_prepare(p, d, true, bn, d, 3, p_x, p_lo, ldw, &px, &ldp, s) ||
      !tf32_prepare(cen, d, true, k, d, 3, c_x, c_lo, ldw, &cx, &ldc, s) ||
      !tf32_kmajor_map(&pm, px, bn, d, ldp, A_BM, A_BK) ||
      !tf32_kmajor_map(&cm, cx, k, d, ldc, A_BN, A_BK) ||
      !tf32_kmajor_map(&plm, p_lo, bn, d, ldw, A_BM, A_BK) ||
      !tf32_kmajor_map(&clm, c_lo, k, d, ldw, A_BN, A_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      lloyd_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      A_SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  lloyd_assign_kernel<<<(bn + A_BM - 1) / A_BM, A_THREADS, A_SMEM, s>>>(
      pm, cm, plm, clm, cn, labels, mind, bn, k, d);
  return static_cast<int>(cudaGetLastError());
}

// The int32 scratch entries bof_lloyd_accumulate needs for bn points and k
// centers: the sorted point indices (bn), the (k x nchunks) table and two
// k-vectors.
extern "C" long long bof_lloyd_accumulate_scratch_ints(int bn, int k) {
  const long long nchunks = (bn + ACC_CHUNK - 1) / ACC_CHUNK;
  return (long long)bn + (long long)k * nchunks + 2LL * k;
}

// sums[j] += the sum of the points labelled j, counts[j] += their number,
// for j < k; every label must lie in [0, k).  `scratch` holds
// `scratch_ints` int32, at least bof_lloyd_accumulate_scratch_ints(bn, k).
// Launches the five steps on `stream`; returns the first launch error.
extern "C" int bof_lloyd_accumulate(const float* p, const int* labels,
                                    float* sums, int* counts, int* scratch,
                                    long long scratch_ints, int bn, int k,
                                    int d, void* stream) {
  if (bn <= 0 || k <= 0) return 0;
  if (scratch_ints < bof_lloyd_accumulate_scratch_ints(bn, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (bn + ACC_CHUNK - 1) / ACC_CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* order = scratch;
  int* hist = order + bn;
  int* tot = hist + (long long)k * nchunks;
  int* off = tot + k;
  if (k > SHARED_K) {
    const cudaError_t rc = cudaMemsetAsync(
        hist, 0, sizeof(int) * (size_t)k * nchunks, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  acc_hist_kernel<<<nchunks, HIST_THREADS, 0, s>>>(labels, hist, bn, k,
                                                   nchunks);
  acc_scan_kernel<<<(k + SCAN_WARPS - 1) / SCAN_WARPS, SCAN_WARPS * 32, 0,
                    s>>>(hist, tot, k, nchunks);
  acc_offsets_kernel<<<1, OFF_THREADS, 0, s>>>(tot, off, counts, k);
  acc_scatter_kernel<<<nchunks, 32, k <= SHARED_K ? k * sizeof(int) : 0,
                       s>>>(labels, hist, off, order, bn, k, nchunks);
  acc_sum_kernel<<<k, SUM_THREADS, 0, s>>>(p, order, off, tot, sums, d);
  return static_cast<int>(cudaGetLastError());
}
