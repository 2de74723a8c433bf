// Stable block sort (B10), the device block sorter of the out-of-core
// sample sort.
//
// bof_sort_block:
//   out[0:n] = x[0:n] sorted ascending, stably, by a canonical key of each
//   element's bits; x is not written.
//   Replaces bof_tpu/ops/sort.py:135 sort_block's device branch (:138-149,
//   jnp.sort of the block), taken when FlashConfig.sort_compute is
//   'device', in phase 1 (each block of sort_blk_elems elements) and in
//   phase 3 (each bucket).
//
// The order is jnp.sort's: stable, and floats compare on a key where -0.0
// equals +0.0 and every NaN (either sign, any payload) equals every other
// NaN and sorts after +inf.  Each element's own bits are written back, so
// a -NaN comes back as itself and zeros keep their input order.  The key
// of a float maps -0 to +0, any NaN to all ones (above +inf's key), and
// then flips the sign bit of a positive value and every bit of a
// negative one; a signed integer flips its sign bit; unsigned integers
// and bool (as uint8) are their bits.
//
// Design: a least-significant-digit radix sort, 8 bits a pass (4 passes
// for 4-byte elements, 2 for 2-byte, 1 for 1-byte).  Each pass is a
// stable counting sort of the elements by one digit of their key, with
// the key recomputed from the bits (only the bits travel, so a pass
// moves n elements, not key and payload):
//   1. sort_hist_kernel: a block a tile of SORT_TILE elements counts the
//      tile's digits in shared memory; hist[d][tile];
//   2. sort_scan_kernel: a warp a digit turns its row of hist into the
//      exclusive prefix over tiles and writes the digit's total;
//   3. sort_scatter_kernel: a block a tile scans the 256 totals (where
//      each digit's range starts), counts its 8 warps' digits, and each
//      warp writes its 1024 elements in order, 32 a step, ranked among
//      equal digits by lane (__match_any_sync) after the warp's earlier
//      steps and the tile's earlier warps.
// The passes ping-pong between the output and one scratch buffer, so the
// last lands in `out`.  This is the counting sort of B7's accumulate
// (csrc/kmeans.cu acc_*_kernel), by digit instead of by label.
//
// What bounds it: at least the block read once and written once (2 * 64
// MiB for 2^24 fp32 elements, 0.040 ms at 3.35 TB/s).  This simple form
// reads the data twice a pass and writes it once, four passes for 32-bit
// elements, with scattered 4-byte writes.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py) 2^24 float32 elements take 1.60 ms, 2.5 % of the bound
// and 1.7x torch.sort(stable=True); the scatter kernel is 0.32 ms of each
// pass's 0.36 ms (torch.profiler), and its uncoalesced writes lead: one
// pass over 2^24 bool elements (two digits, so two runs of writes) takes
// 0.11 ms, over uint8 (256 digits) 0.36 ms.  Making it fast (staging a
// tile's elements in shared memory so the writes coalesce, one-sweep
// digit offsets, skipping digits constant over the block) is later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int SORT_WARPS = 8;
constexpr int SORT_THREADS = SORT_WARPS * 32;
constexpr int SORT_STEPS = 32;                        // a warp's steps
constexpr int WARP_ELEMS = SORT_STEPS * 32;           // 1024
constexpr int SORT_TILE = SORT_WARPS * WARP_ELEMS;    // 8192
constexpr int RADIX = 256;
static_assert(RADIX == SORT_THREADS, "a thread a digit");

// the element kinds, as ops/sort_cuda.py numbers them
enum Kind { F32 = 0, F16 = 1, I32 = 2, U32 = 3, I16 = 4, U16 = 5, I8 = 6,
            U8 = 7 };

template <int K> struct Key;
template <> struct Key<F32> {
  using T = uint32_t;
  __device__ static uint32_t of(uint32_t b) {
    if ((b & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;  // any NaN
    if (b == 0x80000000u) b = 0u;                              // -0 -> +0
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
};
template <> struct Key<F16> {
  using T = uint16_t;
  __device__ static uint32_t of(uint16_t h) {
    uint32_t b = h;
    if ((b & 0x7FFFu) > 0x7C00u) return 0xFFFFu;
    if (b == 0x8000u) b = 0u;
    return (b & 0x8000u) ? (~b & 0xFFFFu) : (b | 0x8000u);
  }
};
template <> struct Key<I32> {
  using T = uint32_t;
  __device__ static uint32_t of(uint32_t b) { return b ^ 0x80000000u; }
};
template <> struct Key<U32> {
  using T = uint32_t;
  __device__ static uint32_t of(uint32_t b) { return b; }
};
template <> struct Key<I16> {
  using T = uint16_t;
  __device__ static uint32_t of(uint16_t b) { return b ^ 0x8000u; }
};
template <> struct Key<U16> {
  using T = uint16_t;
  __device__ static uint32_t of(uint16_t b) { return b; }
};
template <> struct Key<I8> {
  using T = uint8_t;
  __device__ static uint32_t of(uint8_t b) { return b ^ 0x80u; }
};
template <> struct Key<U8> {
  using T = uint8_t;
  __device__ static uint32_t of(uint8_t b) { return b; }
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// 1. hist[d * ntiles + t] = the number of tile t's elements whose digit is d.
template <int K>
__global__ void __launch_bounds__(SORT_THREADS)
    sort_hist_kernel(const typename Key<K>::T* __restrict__ src,
                     int* __restrict__ hist, int n, int ntiles, int shift) {
  __shared__ int h[RADIX];
  const int t = blockIdx.x;
  h[threadIdx.x] = 0;
  __syncthreads();
  const int i0 = t * SORT_TILE;
  const int i1 = min(n - i0, SORT_TILE) + i0;
  for (int i = i0 + threadIdx.x; i < i1; i += SORT_THREADS)
    atomicAdd(&h[(Key<K>::of(src[i]) >> shift) & 0xFF], 1);
  __syncthreads();
  hist[static_cast<long long>(threadIdx.x) * ntiles + t] = h[threadIdx.x];
}

// 2. A warp a digit: its row of hist becomes the exclusive prefix over
// tiles (where tile t's elements of digit d start within d's range), and
// tot[d] the digit's count.
__global__ void __launch_bounds__(SORT_THREADS)
    sort_scan_kernel(int* __restrict__ hist, int* __restrict__ tot,
                     int ntiles) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * SORT_WARPS + (threadIdx.x >> 5);
  int* row = hist + static_cast<long long>(d) * ntiles;
  int run = 0;
  for (int c0 = 0; c0 < ntiles; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < ntiles ? row[c] : 0;
    const int incl = warp_inclusive_scan(v, lane);
    if (c < ntiles) row[c] = run + incl - v;
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tot[d] = run;
}

// 3. A block a tile writes its elements to their places in dst, stably.
template <int K>
__global__ void __launch_bounds__(SORT_THREADS)
    sort_scatter_kernel(const typename Key<K>::T* __restrict__ src,
                        typename Key<K>::T* __restrict__ dst,
                        const int* __restrict__ hist,
                        const int* __restrict__ tot, int n, int ntiles,
                        int shift) {
  using T = typename Key<K>::T;
  __shared__ int base[SORT_WARPS][RADIX];  // where a warp's digit goes next
  __shared__ int start[RADIX];             // where the tile's digit starts
  __shared__ int warp_sum[SORT_WARPS];
  const int t = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < SORT_WARPS * RADIX; j += SORT_THREADS)
    (&base[0][0])[j] = 0;
  {  // thread j: digit j's range starts after every smaller digit's
    const int j = threadIdx.x;
    const int v = tot[j];
    const int incl = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < SORT_WARPS ? warp_sum[lane] : 0;
      w = warp_inclusive_scan(w, lane);
      if (lane < SORT_WARPS) warp_sum[lane] = w;
    }
    __syncthreads();
    start[j] = (warp ? warp_sum[warp - 1] : 0) + incl - v +
               hist[static_cast<long long>(j) * ntiles + t];
  }
  // this warp's 1024 elements: step s, lane l holds element i0 + 32 s + l
  const int i0 = t * SORT_TILE + warp * WARP_ELEMS;
  T val[SORT_STEPS];
  int dig[SORT_STEPS];
#pragma unroll
  for (int s = 0; s < SORT_STEPS; ++s) {
    const int i = i0 + s * 32 + lane;
    const bool live = i0 < n && s * 32 + lane < n - i0;
    val[s] = live ? src[i] : T(0);
    dig[s] = live ? static_cast<int>((Key<K>::of(val[s]) >> shift) & 0xFF)
                  : -1;  // -1: past the end, matches no digit
  }
#pragma unroll
  for (int s = 0; s < SORT_STEPS; ++s)
    if (dig[s] >= 0) atomicAdd(&base[warp][dig[s]], 1);
  __syncthreads();
  {  // thread j: each warp's first place for digit j, warps in order
    const int j = threadIdx.x;
    int run = start[j];
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = base[w][j];
      base[w][j] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SORT_STEPS; ++s) {
    const int j = dig[s];
    const unsigned peers = __match_any_sync(0xffffffffu, j);
    if (j >= 0) {
      const int at = base[warp][j];
      dst[at + __popc(peers & ((1u << lane) - 1u))] = val[s];
      __syncwarp(peers);
      if (lane == __ffs(peers) - 1) base[warp][j] = at + __popc(peers);
    }
    __syncwarp();
  }
}

template <int K>
int run_sort(void* out, const void* x, void* scratch, int* hist, int n,
             cudaStream_t st) {
  using T = typename Key<K>::T;
  const int passes = static_cast<int>(sizeof(T));
  const int ntiles = (n + SORT_TILE - 1) / SORT_TILE;
  int* tot = hist + static_cast<long long>(RADIX) * ntiles;
  const T* src = static_cast<const T*>(x);
  for (int p = 0; p < passes; ++p) {
    // the last pass writes `out`, the one before it the scratch, ...
    T* dst = static_cast<T*>(((passes - 1 - p) % 2 == 0) ? out : scratch);
    const int shift = 8 * p;
    sort_hist_kernel<K><<<ntiles, SORT_THREADS, 0, st>>>(src, hist, n,
                                                         ntiles, shift);
    sort_scan_kernel<<<RADIX / SORT_WARPS, SORT_THREADS, 0, st>>>(hist, tot,
                                                                  ntiles);
    sort_scatter_kernel<K><<<ntiles, SORT_THREADS, 0, st>>>(
        src, dst, hist, tot, n, ntiles, shift);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

// int32 scratch entries bof_sort_block needs for n elements (hist and the
// digit totals).
extern "C" long long bof_sort_block_scratch_ints(long long n) {
  return static_cast<long long>(RADIX) * ((n + SORT_TILE - 1) / SORT_TILE) +
         RADIX;
}

// out (n elements) = x (n elements) sorted as the header says, all on the
// current device; `scratch` holds n elements (unused for 1-byte kinds),
// `hist` bof_sort_block_scratch_ints(n) ints.  Returns cudaGetLastError()
// after the launches; cudaErrorInvalidValue for an unknown kind or n past
// INT_MAX.
extern "C" int bof_sort_block(void* out, const void* x, void* scratch,
                              int* hist, long long n, int kind,
                              void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX - SORT_TILE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  switch (kind) {
    case F32: return run_sort<F32>(out, x, scratch, hist, m, st);
    case F16: return run_sort<F16>(out, x, scratch, hist, m, st);
    case I32: return run_sort<I32>(out, x, scratch, hist, m, st);
    case U32: return run_sort<U32>(out, x, scratch, hist, m, st);
    case I16: return run_sort<I16>(out, x, scratch, hist, m, st);
    case U16: return run_sort<U16>(out, x, scratch, hist, m, st);
    case I8: return run_sort<I8>(out, x, scratch, hist, m, st);
    case U8: return run_sort<U8>(out, x, scratch, hist, m, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
