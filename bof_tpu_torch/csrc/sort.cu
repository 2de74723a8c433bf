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
// What bounds it: bytes.  At least the block read once and written once
// (2 * 64 MiB for 2^24 float32 elements, 0.040 ms at 3.35 TB/s).  A
// least-significant-digit radix sort of 8-bit digits moves the block once
// a digit, so its own floor is higher: 2 * passes + 1 reads or writes of
// the block, 9 * 64 MiB = 0.180 ms for 32-bit elements, 0.040 ms a pass.
//
// Design: a one-sweep LSD radix sort (Adinets and Merrill, "Onesweep",
// 2022), 8 bits a pass (4 passes for 4-byte elements, 2 for 2-byte, 1 for
// 1-byte), only the bits travelling (each pass recomputes the key):
//   0. one cudaMemsetAsync zeroes the work area (histograms, tile
//      counters, status words);
//   1. sort_hist_kernel reads the block once, 16 bytes a load, and counts
//      every pass's digits at once into per-warp sub-histograms in shared
//      memory, then into hist[pass][digit]; the last block to finish
//      scans each pass's 256 counts into the digit starts;
//   2. a sort_onesweep_kernel launch a pass, a block of SORT_THREADS a
//      tile of SORT_TILE elements.  The block takes its tile id from an
//      atomic counter (a block only ever waits on tiles taken before its
//      own, which are running, so the look-back cannot deadlock); loads
//      the tile warp-striped (a warp's 32 lanes read 32 consecutive
//      elements); ranks each element among the tile's elements of its
//      digit in input order (within a warp item by item, the lanes of one
//      digit found by a ballot a differing bit, the digit's highest lane
//      bumping the warp's counter; then the warps' counts in warp order);
//      publishes its 256 digit counts as "aggregate" status words; writes
//      the tile into shared memory in digit order; looks back over the
//      earlier tiles' status words (thread d for digit d, LOOKBACK words
//      a read) to the nearest "inclusive prefix" and publishes its own;
//      and writes shared position j to dst[digit_start[d] + prefix[d] + j
//      - local_start[d]], consecutive threads on consecutive addresses
//      within each digit's run.  Whole tiles take a body with no checks
//      against the block's end.
// A status word is 64 bits: the flag above, the count in the low 32 (up
// to 2^31 - SORT_TILE, SORT_MAX_ELEMS in ops/sort_cuda.py).  The flag is
// 2p + 1 (aggregate) or 2p + 2 (inclusive prefix) in pass p, so a word
// left by an earlier pass, like a zeroed one, reads as not yet published:
// one reset before the first pass serves every pass.  The count travels
// in the word with its flag and no other data hangs on the flag, so the
// words are written and read relaxed at gpu scope (one aligned 64-bit
// access is single-copy atomic); st.release.gpu and a fence after the
// look-back made the sort 18-34 % slower and ordered nothing it reads
// (tools/torch_b10_variants.py, 'release_acquire').  The passes ping-pong
// between the output and one scratch buffer, so the last lands in `out`;
// every pass runs, even one whose digit is the same for the whole block.
//
// The first design (commit b00fa6e) ran a histogram, a scan and a scatter
// kernel a pass: it read the block twice a pass, and each warp stored its 32
// elements of a step straight to their places, up to 32 digit runs and 32
// sectors a store.  This design reads the block 1 + passes times and
// stores whole runs from shared memory.  On an H100 80GB HBM3 at 700 W, on
// the card alone, at 2^24 elements (tools/torch_b10_variants.py, both in
// one run): float32 0.51 ms against 1.53 (7.8 % of the bound, 2.8 times
// this design's floor; torch.sort(stable=True) 0.89), 2-byte kinds
// 0.25-0.26 against 0.68-0.80, 1-byte 0.12 against 0.32-0.33, bool 0.084
// against 0.086.  What holds it there is instruction issue and latency,
// not bytes: a pass costs about as much for 1-byte as for 4-byte elements;
// two 512-thread blocks an SM (64 registers a thread) leave the tile's
// load, the tile counter and the look-back's L2 round trips exposed.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int RADIX = 256;
constexpr int MAX_PASSES = 4;
constexpr int SORT_THREADS = 512;                     // one-sweep block
constexpr int SORT_ITEMS = 15;                        // a thread's elements
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int WARP_TILE = SORT_ITEMS * 32;            // a warp's elements
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;  // a block's elements
static_assert(SORT_THREADS >= RADIX && SORT_THREADS % 32 == 0 &&
                  SORT_THREADS <= 1024,
              "a thread a digit, whole warps");
static_assert(SORT_TILE < (1 << 16), "a rank and its digit share an int");
// 1024 threads an SM, so 64 registers a thread at most
constexpr int SORT_MIN_BLOCKS = 1024 / SORT_THREADS;
constexpr int HIST_THREADS = 256;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_BLOCK_ELEMS = 1 << 15;  // the histogram's grid: a block
constexpr int HIST_MAX_BLOCKS = 512;       //   per 2^15 elements, at most 512
constexpr int HIST_LOADS = 4;              // 16-byte loads a lane a step
constexpr int LOOKBACK = 8;                // status words read at once
constexpr unsigned FULL = 0xffffffffu;

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

template <int K>
__device__ __forceinline__ int digit(typename Key<K>::T v, int shift) {
  return static_cast<int>((Key<K>::of(v) >> shift) & 0xFFu);
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// The exclusive prefix sum of v over the block's threads in order (the
// caller passes 0 past the values it scans); every thread must call it.
// `sums` holds THREADS / 32 ints of shared memory.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < THREADS / 32 ? sums[lane] : 0;
    const int wi = warp_inclusive_scan(w, lane);
    if (lane < THREADS / 32) sums[lane] = wi - w;
  }
  __syncthreads();
  const int out = sums[warp] + incl - v;
  __syncthreads();  // sums may be reused
  return out;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The sum of one digit's counts over the tiles before `tile`: `words`
// points at the digit's status word of tile 0 (a tile's words are RADIX
// apart).  It reads LOOKBACK tiles' words at once, nearest first, adds
// them up to the first that holds an inclusive prefix, and reads again
// from the first not yet published in this pass (flag below `aggregate`).
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* words, int tile, unsigned long long aggregate,
    unsigned long long prefix) {
  unsigned sum = 0;
  int t = tile - 1;  // the nearest tile not yet added
  for (;;) {
    unsigned long long s[LOOKBACK];
#pragma unroll
    for (int k = 0; k < LOOKBACK; ++k)  // tile 0 holds a prefix: never past
      s[k] = t - k >= 0
                 ? ld_relaxed(words + static_cast<long long>(t - k) * RADIX)
                 : prefix;
    int k = 0;
#pragma unroll
    for (; k < LOOKBACK; ++k) {
      if (s[k] < aggregate) break;
      sum += static_cast<unsigned>(s[k]);
      if (s[k] >= prefix) return sum;
    }
    t -= k;
  }
}

// The lanes of the warp whose 8-bit digit d equals this lane's: a ballot
// for each bit that differs across the warp (a multi-split; all 8 on
// random digits, none where the warp shares one digit, one for bool).
// __match_any_sync costs more on many distinct digits.
__device__ __forceinline__ unsigned same_digit_lanes(int d) {
  const unsigned u = static_cast<unsigned>(d);
  unsigned differ = __reduce_or_sync(FULL, u) ^ __reduce_and_sync(FULL, u);
  unsigned peers = FULL;
  if (differ == 0xFFu) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned ones = __ballot_sync(FULL, (u >> b) & 1u);
      peers &= ones ^ (((u >> b) & 1u) - 1u);  // ones where set, else zeros
    }
    return peers;
  }
  while (differ) {  // the same trip count in every lane
    const unsigned bit = differ & (0u - differ);
    differ ^= bit;
    const bool set = u & bit;
    peers &= __ballot_sync(FULL, set) ^ (set ? 0u : FULL);
  }
  return peers;
}

// Count one key's P digits into this warp's sub-histograms h[P][RADIX]
// (`live` false: nothing to count).
template <int P>
__device__ __forceinline__ void count_digits(int (*h)[RADIX], uint32_t key,
                                             bool live) {
  if (!live) return;
#pragma unroll
  for (int p = 0; p < P; ++p) atomicAdd(&h[p][(key >> (8 * p)) & 0xFFu], 1);
}

// 1. hist[p * RADIX + d] = the number of elements whose pass-p digit is d,
// for every pass at once; the last block to finish writes
// starts[p * RADIX + d] = the number of elements whose pass-p digit is
// below d.  hist and *done start at 0.
template <int K>
__global__ void __launch_bounds__(HIST_THREADS)
    sort_hist_kernel(const typename Key<K>::T* __restrict__ src, int n,
                     int* __restrict__ hist, int* __restrict__ starts,
                     unsigned* __restrict__ done) {
  using T = typename Key<K>::T;
  constexpr int P = static_cast<int>(sizeof(T));  // passes
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements a load
  __shared__ int h[HIST_WARPS][P][RADIX];
  __shared__ int sums[HIST_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < HIST_WARPS * P * RADIX; j += HIST_THREADS)
    (&h[0][0][0])[j] = 0;
  __syncthreads();
  // the elements before the first 16-byte boundary, whole 16-byte words,
  // and the rest
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int head = min(n, static_cast<int>(((16u - (a & 15u)) & 15u) /
                                           sizeof(T)));
  const int nvec = (n - head) / V;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  const int stride = gridDim.x * HIST_WARPS * 32 * HIST_LOADS;
  for (int w0 = (blockIdx.x * HIST_WARPS + warp) * 32 * HIST_LOADS;
       w0 < nvec; w0 += stride) {
    uint4 v[HIST_LOADS];
#pragma unroll
    for (int u = 0; u < HIST_LOADS; ++u) {
      const int w = w0 + u * 32 + lane;
      v[u] = w < nvec ? vsrc[w] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < HIST_LOADS; ++u) {
      const bool live = w0 + u * 32 + lane < nvec;
      T e[V];
      static_assert(sizeof(e) == sizeof(uint4), "a word's elements");
      memcpy(e, &v[u], sizeof(e));
#pragma unroll
      for (int j = 0; j < V; ++j)
        count_digits<P>(h[warp], Key<K>::of(e[j]), live);
    }
  }
  if (blockIdx.x == 0 && warp == 0) {  // head + tail < 2 V <= 32 elements
    const int rest = n - nvec * V;
    const int i = lane < head ? lane : lane + nvec * V;
    const bool live = lane < rest;
    count_digits<P>(h[warp], live ? Key<K>::of(src[i]) : 0u, live);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < P * RADIX; j += HIST_THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) s += (&h[w][0][0])[j];
    if (s) atomicAdd(&hist[j], s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  static_assert(HIST_THREADS == RADIX, "a thread a digit");
  for (int p = 0; p < P; ++p) {
    const int c = __ldcg(&hist[p * RADIX + threadIdx.x]);
    starts[p * RADIX + threadIdx.x] =
        block_exclusive_scan<HIST_THREADS>(c, sums);
  }
}

// The one-sweep kernel's shared memory (dynamic: past 48 KiB for 4-byte
// elements).
template <typename T>
struct Onesweep {
  T keys[SORT_TILE];              // the tile in digit order
  unsigned char digs[SORT_TILE];  // and their digits
  // cnt[w][d]: warp w's count of digit d, then where its first element of
  // digit d goes in the tile's digit order
  int cnt[SORT_WARPS][RADIX];
  int base[RADIX];  // dst index of tile position j of digit d: base[d] + j
  int sums[SORT_WARPS];
  int tile;
};

// 2. One pass: dst = src stably sorted by the digit at `shift`, a block a
// tile (see the header).  starts: the pass's 256 digit starts; status:
// ntiles * RADIX words; *next_tile starts at 0.  WHOLE: the tile has
// SORT_TILE elements (every tile but the last), so nothing is checked
// against its end.
template <int K, bool WHOLE>
__device__ __forceinline__ void onesweep_tile(
    const typename Key<K>::T* __restrict__ src,
    typename Key<K>::T* __restrict__ dst, const int* __restrict__ starts,
    unsigned long long* __restrict__ status, Onesweep<typename Key<K>::T>& sm,
    int tile, int valid, int pass) {
  using T = typename Key<K>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = 8 * pass;
  const unsigned long long AGGREGATE =
      static_cast<unsigned long long>(2 * pass + 1) << 32;
  const unsigned long long PREFIX =
      static_cast<unsigned long long>(2 * pass + 2) << 32;
  // item i of lane l: the tile's element warp * WARP_TILE + 32 i + l
  const int first = warp * WARP_TILE + lane;
  const T* in = src + static_cast<long long>(tile) * SORT_TILE + first;
  T val[SORT_ITEMS];
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i)
    val[i] = WHOLE || first + 32 * i < valid ? in[32 * i] : T(0);
  // rank[i]: the element's digit << 16 and its place among the warp's
  // elements of that digit, in input order (items in order, lanes in order
  // within an item).  Past the end an element takes digit RADIX - 1: it
  // comes last in the tile's digit order and is never written out.  A
  // digit's highest lane adds the item's count to the warp's counter and
  // hands the old count to the others.
  int rank[SORT_ITEMS];
  const unsigned upto_me = (2u << lane) - 1u;  // lanes 0..lane
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    const int d = WHOLE || first + 32 * i < valid ? digit<K>(val[i], shift)
                                                  : RADIX - 1;
    const unsigned peers = same_digit_lanes(d);
    const int leader = 31 - __clz(peers);
    const int upto = __popc(peers & upto_me);
    int before = 0;
    if (lane == leader) before = atomicAdd(&sm.cnt[warp][d], upto);
    rank[i] = d << 16 | (__shfl_sync(FULL, before, leader) + upto - 1);
  }
  __syncthreads();
  // thread d: each warp's start within digit d, and the tile's count of
  // d, published for the tiles after this one
  int run = 0;
  unsigned own = 0;
  if (threadIdx.x < RADIX) {
    const int d = threadIdx.x;
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = sm.cnt[w][d];
      sm.cnt[w][d] = run;
      run += c;
    }
    own = static_cast<unsigned>(
        run - (!WHOLE && d == RADIX - 1 ? SORT_TILE - valid : 0));
    st_relaxed(&status[static_cast<long long>(tile) * RADIX + d],
               (tile == 0 ? PREFIX : AGGREGATE) | own);
  }
  const int local = block_exclusive_scan<SORT_THREADS>(run, sm.sums);
  if (threadIdx.x < RADIX) {
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) sm.cnt[w][threadIdx.x] += local;
  }
  __syncthreads();
  // the tile into shared memory in digit order
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    if (WHOLE || first + 32 * i < valid) {
      const int d = rank[i] >> 16;
      const int at = sm.cnt[warp][d] + (rank[i] & 0xFFFF);
      sm.keys[at] = val[i];
      sm.digs[at] = static_cast<unsigned char>(d);
    }
  }
  // thread d: digit d's elements in the tiles before this one (the
  // look-back), this tile's inclusive prefix published, and where the
  // tile's run of d goes
  if (threadIdx.x < RADIX) {
    const int d = threadIdx.x;
    unsigned before = 0;
    if (tile > 0) {
      before = look_back(status + d, tile, AGGREGATE, PREFIX);
      st_relaxed(&status[static_cast<long long>(tile) * RADIX + d],
                 PREFIX | (before + own));
    }
    sm.base[d] = starts[d] + static_cast<int>(before) - local;
  }
  __syncthreads();
  // out, a run of consecutive addresses a digit
#pragma unroll
  for (int k = 0; k < SORT_ITEMS; ++k) {
    const int j = k * SORT_THREADS + threadIdx.x;
    if (WHOLE || j < valid) dst[sm.base[sm.digs[j]] + j] = sm.keys[j];
  }
}

template <int K>
__global__ void __launch_bounds__(SORT_THREADS, SORT_MIN_BLOCKS)
    sort_onesweep_kernel(const typename Key<K>::T* __restrict__ src,
                         typename Key<K>::T* __restrict__ dst,
                         const int* __restrict__ starts,
                         unsigned long long* __restrict__ status,
                         int* __restrict__ next_tile, int n, int pass) {
  using T = typename Key<K>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Onesweep<T>& sm = *reinterpret_cast<Onesweep<T>*>(smem);
  if (threadIdx.x == 0) sm.tile = atomicAdd(next_tile, 1);
  for (int j = threadIdx.x; j < SORT_WARPS * RADIX; j += SORT_THREADS)
    (&sm.cnt[0][0])[j] = 0;
  __syncthreads();
  const int tile = sm.tile;
  const int valid = min(n - tile * SORT_TILE, SORT_TILE);
  if (valid == SORT_TILE)
    onesweep_tile<K, true>(src, dst, starts, status, sm, tile, valid, pass);
  else
    onesweep_tile<K, false>(src, dst, starts, status, sm, tile, valid, pass);
}

// The work area, in ints: the status words first (8-byte aligned), then
// hist and starts (MAX_PASSES * RADIX each), the passes' tile counters and
// the histogram's done count.
long long tiles_of(long long n) { return (n + SORT_TILE - 1) / SORT_TILE; }

long long work_ints(long long n) {
  return 2 * RADIX * tiles_of(n) + 2 * MAX_PASSES * RADIX + MAX_PASSES + 2;
}

template <int K>
int run_sort(void* out, const void* x, void* scratch, int* work, int n,
             cudaStream_t st) {
  using T = typename Key<K>::T;
  constexpr int passes = static_cast<int>(sizeof(T));
  const long long ntiles = tiles_of(n);
  auto* status = reinterpret_cast<unsigned long long*>(work);
  int* hist = work + 2 * RADIX * ntiles;
  int* starts = hist + MAX_PASSES * RADIX;
  int* next_tile = starts + MAX_PASSES * RADIX;
  auto* done = reinterpret_cast<unsigned*>(next_tile + MAX_PASSES);
  cudaError_t err = cudaMemsetAsync(
      work, 0, static_cast<size_t>(work_ints(n)) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hist_blocks = static_cast<int>(
      std::min<long long>((n + HIST_BLOCK_ELEMS - 1) / HIST_BLOCK_ELEMS,
                          HIST_MAX_BLOCKS));
  const T* src = static_cast<const T*>(x);
  sort_hist_kernel<K><<<hist_blocks, HIST_THREADS, 0, st>>>(src, n, hist,
                                                            starts, done);
  constexpr int smem = static_cast<int>(sizeof(Onesweep<T>));
  err = cudaFuncSetAttribute(sort_onesweep_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);  // past 48 KiB
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p = 0; p < passes; ++p) {
    // the last pass writes `out`, the one before it the scratch, ...
    T* dst = static_cast<T*>(((passes - 1 - p) % 2 == 0) ? out : scratch);
    sort_onesweep_kernel<K><<<static_cast<int>(ntiles), SORT_THREADS, smem,
                              st>>>(src, dst, starts + p * RADIX, status,
                                    next_tile + p, n, p);
    src = dst;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 entries of the work area bof_sort_block needs for n elements: a
// 64-bit status word per (SORT_TILE-element tile, digit), reused by every
// pass; the digit counts of every pass (MAX_PASSES * 256) and their
// exclusive scans, the digit starts; a tile counter a pass; and the
// histogram's count of finished blocks.
extern "C" long long bof_sort_block_scratch_ints(long long n) {
  return work_ints(n);
}

// out (n elements) = x (n elements) sorted as the header says, all on the
// current device; `scratch` holds n elements (unused for 1-byte kinds),
// `work` bof_sort_block_scratch_ints(n) ints, 8-byte aligned; nothing is
// allocated, and nothing waits for the card.  Returns cudaGetLastError()
// after the launches; cudaErrorInvalidValue for an unknown kind or n past
// 2^31 - SORT_TILE.
extern "C" int bof_sort_block(void* out, const void* x, void* scratch,
                              int* work, long long n, int kind,
                              void* stream) {
  if (n <= 0) return 0;
  if (n > (1LL << 31) - SORT_TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  switch (kind) {
    case F32: return run_sort<F32>(out, x, scratch, work, m, st);
    case F16: return run_sort<F16>(out, x, scratch, work, m, st);
    case I32: return run_sort<I32>(out, x, scratch, work, m, st);
    case U32: return run_sort<U32>(out, x, scratch, work, m, st);
    case I16: return run_sort<I16>(out, x, scratch, work, m, st);
    case U16: return run_sort<U16>(out, x, scratch, work, m, st);
    case I8: return run_sort<I8>(out, x, scratch, work, m, st);
    case U8: return run_sort<U8>(out, x, scratch, work, m, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
