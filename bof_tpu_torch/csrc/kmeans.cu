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
// What bounds lloyd_assign: 2 * bn * k * d operations on bn * d + k * d
// floats; at the streamed block of S11 (bn 131072, d 128, k 1024) that is
// 34.4 GFLOP on 65 MB, so fp32 FFMA (67 TFLOP/s) bounds it at 0.513 ms and
// the bytes at 0.02 ms.  The point of a hand kernel is what it does not
// write: the (bn x k) distance block (512 MiB at S11) never leaves
// registers.  Design: a block owns 128 points and walks all centers in tiles
// of 128; each tile is the FFMA SGEMM tile of matmul.cu (BK 8 slabs of d
// through two shared-memory stages, 256 threads each with an 8x8 fp32
// accumulator, full fp32 at every matmul_precision), and its epilogue folds
// the 64 distances into a running (min, argmin) for the thread's 8 points.
// After the last tile the 16 threads that share a point row (a half-warp)
// reduce their candidates with shuffles, smaller index first on a tie.
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

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // points a block
constexpr int BN = 128;  // centers a tile
constexpr int BK = 8;
constexpr int PAD = 4;
constexpr int THREADS = 256;
constexpr int LOADS = BM * BK / THREADS;  // 4 floats of P (and of C) a thread

__device__ __forceinline__ void tile_coord(int e, int& outer, int& kk) {
  // both operands are stored K-contiguous (rows of d floats)
  const int idx = threadIdx.x + e * THREADS;
  kk = idx % BK;
  outer = idx / BK;
}

__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v < bv || (v == bv && j < bj);
}

__global__ void __launch_bounds__(THREADS)
lloyd_assign_kernel(const float* __restrict__ p, const float* __restrict__ cen,
                    const float* __restrict__ cn, int* __restrict__ labels,
                    float* __restrict__ mind, int bn, int k, int d) {
  __shared__ __align__(16) float Ps[2][BK][BM + PAD];
  __shared__ __align__(16) float Cs[2][BK][BN + PAD];

  const int tx = threadIdx.x % 16;  // centers tx*4.., 64+tx*4..
  const int ty = threadIdx.x / 16;  // points ty*4.., 64+ty*4..
  const int m0 = blockIdx.x * BM;

  float best_v[8];
  int best_j[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_v[i] = __int_as_float(0x7f800000);  // +inf
    best_j[i] = 0;
  }

  float rp[LOADS], rc[LOADS];
  const int nslabs = (d + BK - 1) / BK;
  for (int n0 = 0; n0 < k; n0 += BN) {
    auto load_tiles = [&](int k0) {
#pragma unroll
      for (int e = 0; e < LOADS; ++e) {
        int oo, kk;
        tile_coord(e, oo, kk);
        const int gk = k0 + kk;
        const int gm = m0 + oo, gn = n0 + oo;
        rp[e] = (gm < bn && gk < d) ? p[(long long)gm * d + gk] : 0.f;
        rc[e] = (gn < k && gk < d) ? cen[(long long)gn * d + gk] : 0.f;
      }
    };
    auto store_tiles = [&](int s) {
#pragma unroll
      for (int e = 0; e < LOADS; ++e) {
        int oo, kk;
        tile_coord(e, oo, kk);
        Ps[s][kk][oo] = rp[e];
        Cs[s][kk][oo] = rc[e];
      }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // the previous tile's last barrier follows its last read of either stage
    load_tiles(0);
    store_tiles(0);
    __syncthreads();
    for (int t = 0; t < nslabs; ++t) {
      const int cur = t & 1;
      if (t + 1 < nslabs) load_tiles((t + 1) * BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Ps[cur][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Ps[cur][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Cs[cur][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Cs[cur][kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (t + 1 < nslabs) store_tiles(cur ^ 1);
      __syncthreads();
    }

    // fold this tile's distances into the running (min, argmin), centers in
    // increasing index order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gj >= k) continue;
      const float cnj = cn[gj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = cnj - 2.f * acc[i][j];
        if (better(v, gj, best_v[i], best_j[i])) {
          best_v[i] = v;
          best_j[i] = gj;
        }
      }
    }
  }

  // the 16 threads of a point row are one half-warp (lanes tx = 0..15)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best_v[i], off);
      const int j = __shfl_xor_sync(0xffffffffu, best_j[i], off);
      if (better(v, j, best_v[i], best_j[i])) {
        best_v[i] = v;
        best_j[i] = j;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (gm < bn) {
        labels[gm] = best_j[i];
        mind[gm] = best_v[i];
      }
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

// labels[i], mind[i] for the bn points of p against the k centers (module
// comment), launched on `stream`.  Returns the CUDA error of the launch.
extern "C" int bof_lloyd_assign(const float* p, const float* cen,
                                const float* cn, int* labels, float* mind,
                                int bn, int k, int d, void* stream) {
  if (bn <= 0) return 0;
  const int grid = (bn + BM - 1) / BM;
  lloyd_assign_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, cen, cn, labels, mind, bn, k, d);
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
