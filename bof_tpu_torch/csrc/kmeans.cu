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
// What bounds lloyd_accumulate: reading P once (bn * d * 4 bytes) and sums
// and counts once each way, 0.02 ms at S11.  Design: one block a center,
// deterministic: the block scans the labels in chunks, compacts its points'
// indices in index order in shared memory (a block-wide scan), and each
// thread sums one feature of those rows, in index order, then adds that
// block sum to the running sum (as bof_tpu adds each block's one-hot
// product): no atomics, so two runs (and the resident and streamed tiers)
// give the same bits, and a pass over 2^24 points adds 128 block sums per
// center instead of 16384 points into one fp32 sum.  Its time is the label
// scan, which every block repeats (k passes over bn labels, from L2).

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

constexpr int ACC_THREADS = 128;               // features a pass
constexpr int ACC_PER_THREAD = 16;             // labels a thread checks a chunk
constexpr int ACC_CHUNK = ACC_THREADS * ACC_PER_THREAD;

__global__ void __launch_bounds__(ACC_THREADS)
lloyd_accumulate_kernel(const float* __restrict__ p,
                        const int* __restrict__ labels,
                        float* __restrict__ sums, int* __restrict__ counts,
                        int bn, int d) {
  __shared__ int list[ACC_CHUNK];
  __shared__ int warp_total[ACC_THREADS / 32];
  const int center = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int total = 0;
  for (int f0 = 0; f0 < d; f0 += ACC_THREADS) {
    const int f = f0 + threadIdx.x;
    float acc = 0.f;
    total = 0;
    for (int i0 = 0; i0 < bn; i0 += ACC_CHUNK) {
      // this thread's labels i0 + tid*16 .. +15, in index order
      const int base = i0 + threadIdx.x * ACC_PER_THREAD;
      unsigned hits = 0;
#pragma unroll
      for (int e = 0; e < ACC_PER_THREAD; ++e)
        if (base + e < bn && labels[base + e] == center) hits |= 1u << e;
      // exclusive block-wide scan of the hit counts: index order overall
      const int mine = __popc(hits);
      int incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (lane == 31) warp_total[warp] = incl;
      __syncthreads();
      int pos = incl - mine, chunk_total = 0;
#pragma unroll
      for (int w = 0; w < ACC_THREADS / 32; ++w) {
        if (w < warp) pos += warp_total[w];
        chunk_total += warp_total[w];
      }
      while (hits) {
        const int e = __ffs(hits) - 1;
        hits &= hits - 1;
        list[pos++] = base + e;
      }
      __syncthreads();
      if (f < d)
        for (int q = 0; q < chunk_total; ++q)
          acc += p[(long long)list[q] * d + f];
      total += chunk_total;
      __syncthreads();  // list and warp_total are rewritten next chunk
    }
    if (f < d) sums[(long long)center * d + f] += acc;
  }
  if (threadIdx.x == 0) counts[center] += total;
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

// sums[j] += the sum of the points labelled j, counts[j] += their number,
// for j < k; every label must lie in [0, k).  Returns the launch's error.
extern "C" int bof_lloyd_accumulate(const float* p, const int* labels,
                                    float* sums, int* counts, int bn, int k,
                                    int d, void* stream) {
  if (bn <= 0 || k <= 0) return 0;
  lloyd_accumulate_kernel<<<k, ACC_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, labels, sums, counts, bn, d);
  return static_cast<int>(cudaGetLastError());
}
