// Masked row top-k (B8), the second half of the fused XML ranking step.
//
// bof_row_topk:
//   for each row r of s (rows x cols, fp32, row-major):
//     x[c] = s[r, c] + mask[c]            (one fp32 add; mask may be null)
//     vals[r, :k], idx[r, :k] = the k largest x[c] and their columns c,
//     value descending, the lower column first on equal values.
//   Replaces the top-k of bof_tpu/apps/xml_rank.py:48 _topk_step (its step
//   at :60-62: lax.top_k of the ELL block product plus the label mask);
//   the product itself is kernel K2 (csrc/spmm_ell.cu), launched before.
//
// The order is jax.lax.top_k's on the CPU, which is XLA's total order of
// floats: a float's bits b map to the int32 key b for b >= 0 and
// b ^ 0x7FFFFFFF for b < 0, and larger keys come first.  So +NaN is above
// +inf, -NaN below -inf, +0 above -0, and equal keys (equal bits) go by the
// lower column.  Keys and columns are packed into one 64-bit integer,
// (key << 32) | (0xFFFFFFFF - column), so the order is one integer compare
// and no two entries of a row compare equal.  The values written are x's
// own bits.
//
// What bounds it: the row read once (rows * cols * 4 bytes) and k
// (value, index) pairs written; at the fused step's band (rows 512 to
// 2048, cols 1024, k 5) under 3 microseconds at 3.35 TB/s, so it is bound
// by memory, and in practice by its launch and its load latency.
//
// Rows of up to TOPK_REG_COLS (1024) columns take the register body
// (row_topk_reg_kernel): one warp a row, TOPK_REG_WARPS rows a block.
// Each lane loads its 32 columns (16-byte loads of s and the mask where
// cols is a multiple of 4 and both are 16-byte aligned: lane l owns
// columns 4 (l + 32 q) + e; else columns l + 32 j), adds the mask and
// keeps the 32 keys in registers; columns past cols get key INT_MIN,
// which packs below every real entry of equal key (a larger column).
// Each lane keeps the best packed entry among its columns.  A round is
// two warp reductions (redux.sync: the largest key, then the smallest
// column among the lanes holding that key), with no shared memory and no
// barrier; lane 0 writes the winner, and only the lane that owned it
// looks again among its registers for its best entry below the winner.
// The winners fall strictly from round to round, so nothing is marked
// removed.  Any k from 1 to cols.
//
// Wider rows keep the first design (row_topk_kernel): a block of
// TOPK_THREADS threads a row, each thread owning the columns c = tid + j *
// TOPK_THREADS, a round a block-wide argmax (a warp shuffle reduction,
// then the warps' maxima through shared memory, double-buffered so one
// barrier a round suffices).  Rows of up to TOPK_SMEM_COLS columns keep
// their keys in shared memory (16 KiB); wider rows read s and mask again
// (from L2) when a thread looks again.
//
// tools/torch_b8_variants.py (H100 80GB HBM3 at 700 W, on the card
// alone): at 512 / 2048 x 1024, k 5 the register body takes 0.0049 /
// 0.0095 ms where the first design took 0.0057 / 0.0125 (13 % and 27 % of
// the bound, not half); k 64 0.0277 against 0.0386, k 1024 0.397 against
// 0.565.  A tree of pairwise maxima over an array of the 32 entries
// ('tree_max') is 12 % slower at 2048 rows (95 registers against 80).
// At 512 x 4096 the shared-memory keys take 0.0109 ms, 'l2' 0.0126.
//
// NaN: the card's fp32 add returns the canonical NaN (bits 0x7FFFFFFF), so
// under a mask a -NaN score ranks first as +NaN, where lax.top_k on the
// CPU keeps -NaN and ranks it last; without a mask x is s's own bits.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TOPK_THREADS = 128;
constexpr int TOPK_WARPS = TOPK_THREADS / 32;
constexpr int TOPK_SMEM_COLS = 4096;
constexpr int TOPK_REG_COLS = 1024;  // 32 columns a lane
constexpr int TOPK_REG_SLOTS = TOPK_REG_COLS / 32;
constexpr int TOPK_REG_WARPS = 4;    // rows a block of the register body

__device__ __forceinline__ int32_t sort_key(float x) {
  const int32_t b = __float_as_int(x);
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

__device__ __forceinline__ float key_value(int32_t key) {
  return __int_as_float(key < 0 ? (key ^ 0x7FFFFFFF) : key);
}

__device__ __forceinline__ long long pack(int32_t key, int col) {
  const unsigned long long hi =
      static_cast<unsigned long long>(static_cast<uint32_t>(key)) << 32;
  return static_cast<long long>(
      hi | (0xFFFFFFFFull - static_cast<unsigned long long>(col)));
}

__device__ __forceinline__ int32_t packed_key(long long p) {
  return static_cast<int32_t>(static_cast<unsigned long long>(p) >> 32);
}

__device__ __forceinline__ int packed_col(long long p) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(p));
}

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

template <bool kSmem>
__global__ void __launch_bounds__(TOPK_THREADS)
    row_topk_kernel(float* __restrict__ vals, int* __restrict__ idx,
                    const float* __restrict__ s,
                    const float* __restrict__ mask, int cols, int k) {
  __shared__ int32_t keys[kSmem ? TOPK_SMEM_COLS : 1];
  __shared__ long long red[2][TOPK_WARPS];
  const long long row = blockIdx.x;
  const float* srow = s + row * cols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the masked key of column c, computed from s (and kept in shared
  // memory for narrow rows); each thread reads back only its own columns
  auto fresh_key = [&](int c) {
    float x = srow[c];
    if (mask) x = __fadd_rn(x, mask[c]);
    return sort_key(x);
  };
  long long best = LLONG_MIN;  // below every packed entry
  for (int c = tid; c < cols; c += TOPK_THREADS) {
    const int32_t key = fresh_key(c);
    if (kSmem) keys[c] = key;
    best = max64(best, pack(key, c));
  }

  float* vrow = vals + row * k;
  int* irow = idx + row * k;
  for (int r = 0; r < k; ++r) {
    long long w = best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = max64(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (lane == 0) red[r & 1][warp] = w;
    __syncthreads();
    w = red[r & 1][0];
#pragma unroll
    for (int i = 1; i < TOPK_WARPS; ++i) w = max64(w, red[r & 1][i]);
    const int col = packed_col(w);
    if (tid == 0) {
      vrow[r] = key_value(packed_key(w));
      irow[r] = col;
    }
    if (col % TOPK_THREADS == tid) {  // the winner's owner looks again
      best = LLONG_MIN;
      for (int c = tid; c < cols; c += TOPK_THREADS) {
        const long long p = pack(kSmem ? keys[c] : fresh_key(c), c);
        if (p < w) best = max64(best, p);
      }
    }
  }
}

// The register body: a warp a row (see the header).  kVec: 16-byte loads
// (cols % 4 == 0, s and mask 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(TOPK_REG_WARPS * 32)
    row_topk_reg_kernel(float* __restrict__ vals, int* __restrict__ idx,
                        const float* __restrict__ s,
                        const float* __restrict__ mask, long long rows,
                        int cols, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * TOPK_REG_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: no warp-wide op is left
  const float* srow = s + row * cols;
  // the column of the lane's slot j
  auto col_of = [&](int j) {
    return kVec ? 4 * (lane + 32 * (j >> 2)) + (j & 3) : lane + 32 * j;
  };
  int32_t key[TOPK_REG_SLOTS];
  if (kVec) {
#pragma unroll
    for (int q = 0; q < TOPK_REG_SLOTS / 4; ++q) {
      const int c0 = 4 * (lane + 32 * q);
      if (c0 < cols) {  // cols % 4 == 0: all four are in the row
        float4 v = *reinterpret_cast<const float4*>(srow + c0);
        if (mask) {
          const float4 m = *reinterpret_cast<const float4*>(mask + c0);
          v.x = __fadd_rn(v.x, m.x);
          v.y = __fadd_rn(v.y, m.y);
          v.z = __fadd_rn(v.z, m.z);
          v.w = __fadd_rn(v.w, m.w);
        }
        key[4 * q] = sort_key(v.x);
        key[4 * q + 1] = sort_key(v.y);
        key[4 * q + 2] = sort_key(v.z);
        key[4 * q + 3] = sort_key(v.w);
      } else {
        key[4 * q] = key[4 * q + 1] = key[4 * q + 2] = key[4 * q + 3] =
            INT_MIN;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < TOPK_REG_SLOTS; ++j) {
      const int c = lane + 32 * j;
      float x = 0.f;
      if (c < cols) {
        x = srow[c];
        if (mask) x = __fadd_rn(x, mask[c]);
      }
      key[j] = c < cols ? sort_key(x) : INT_MIN;
    }
  }
  long long best = LLONG_MIN;  // below every packed entry
#pragma unroll
  for (int j = 0; j < TOPK_REG_SLOTS; ++j)
    best = max64(best, pack(key[j], col_of(j)));

  float* vrow = vals + row * k;
  int* irow = idx + row * k;
  for (int r = 0; r < k; ++r) {
    const int32_t bkey = packed_key(best);
    const unsigned bcol = static_cast<unsigned>(packed_col(best));
    const int wkey = __reduce_max_sync(0xffffffffu, bkey);
    const unsigned wcol =
        __reduce_min_sync(0xffffffffu, bkey == wkey ? bcol : 0xFFFFFFFFu);
    if (lane == 0) {
      vrow[r] = key_value(wkey);
      irow[r] = static_cast<int>(wcol);
    }
    if (bkey == wkey && bcol == wcol) {  // the winner's owner looks again
      const long long w = best;
      best = LLONG_MIN;
#pragma unroll
      for (int j = 0; j < TOPK_REG_SLOTS; ++j) {
        const long long p = pack(key[j], col_of(j));
        if (p < w) best = max64(best, p);
      }
    }
  }
}

}  // namespace

// vals (rows, k) fp32 and idx (rows, k) int32 from s (rows, cols) fp32,
// all contiguous on the current device, with mask (cols,) fp32 or null.
// Returns cudaGetLastError() after the launch; a cudaErrorInvalidValue for
// k outside [1, cols] or a row count past one grid.
extern "C" int bof_row_topk(float* vals, int* idx, const float* s,
                            const float* mask, long long rows, int cols,
                            int k, void* stream) {
  if (rows <= 0) return 0;
  if (cols < 1 || k < 1 || k > cols || rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols <= TOPK_REG_COLS) {
    const dim3 grid(
        static_cast<unsigned>((rows + TOPK_REG_WARPS - 1) / TOPK_REG_WARPS));
    const bool vec = cols % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(mask) % 16 == 0;
    if (vec)
      row_topk_reg_kernel<true><<<grid, TOPK_REG_WARPS * 32, 0, st>>>(
          vals, idx, s, mask, rows, cols, k);
    else
      row_topk_reg_kernel<false><<<grid, TOPK_REG_WARPS * 32, 0, st>>>(
          vals, idx, s, mask, rows, cols, k);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(rows));
  if (cols <= TOPK_SMEM_COLS)
    row_topk_kernel<true><<<grid, TOPK_THREADS, 0, st>>>(vals, idx, s, mask,
                                                        cols, k);
  else
    row_topk_kernel<false><<<grid, TOPK_THREADS, 0, st>>>(vals, idx, s, mask,
                                                         cols, k);
  return static_cast<int>(cudaGetLastError());
}
