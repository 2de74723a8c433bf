// ELL sparse x dense products for the out-of-core sparse kernels.
//
// bof_spmm_ell (K2):
//   out[rows[i], :] = alpha * sum_{s < counts[i]} v(i, s) * B[ja[i, s], :]
//   Replaces bof_tpu/sparse/spmm_pallas.py:64 spmm_ell_pallas (the Pallas
//   VMEM-gather kernel) and its XLA twin bof_tpu/sparse/spmm_device.py:22
//   ell_gather_reduce, which compute the same function (without counts,
//   rows and alpha): the device block product of csrmm 'N'.
// bof_spmv_ell (B6):
//   y[rows[i]] = alpha * sum_{s < counts[i]} v(i, s) * x[ja[i, s]]
//   Replaces the XLA step bof_tpu/sparse/spmm_device.py:89 spmv_ell_block,
//   the device block product of csrgemv 'N'.
//
// Layouts, as the planners build them (sparse/spmm_device.py:to_ell_rows):
// B is a row-major (k, cb) fp32 panel; ja and va are row-major (rows, rmax)
// ELL blocks, ja int32 or uint16 (the narrow link dtype, widened here in
// registers, never on the host).  va holds fp32, bf16 or int8 values (the
// transfer modes' link dtypes, FlashConfig.transfer_dtype), and v(i, s) is
// va[i, s] for fp32, its exact fp32 value for bf16, and
// __fmul_rn(float(va[i, s]), va_scale[i]) for int8, with one fp32 scale an
// ELL row (indexed by the ELL row i, not by rows[i]): what bof_tpu/sparse/
// spmm_device.py:promote_ell_vals computes in HBM before its reduction, here
// done in registers as each slot is staged.  Indices must lie in [0, k); the
// planner guarantees it.  Offsets are 64-bit: ja * cb and rows * cb pass
// 2^31 on large panels.
//
// The contract (the same in the wrappers and the plain versions of
// sparse/spmm_cuda.py).  counts (int32, optional) gives each ELL row's real
// slot count: the slot loop stops there, so padding slots are never read
// (null: all rmax slots are real).  rows (int32, optional) gives where ELL
// row i lands in out; only those rows are written and every other row of
// out keeps what it held (null: row i lands at i).  The sum is fp32, then
// times alpha once.  So the csrmm writer downloads one row-block buffer that
// the band launches filled in place, instead of scattering band outputs on
// the host (a scatter serializes on a TPU; here a row lands anywhere for
// free).  A deliberate difference from the reference: bof_tpu multiplies
// padding slots (ja 0, va 0) like real ones, so an Inf or NaN in B row 0
// (or x[0]) turns its padded rows into NaN; these kernels skip padding, as
// the scipy golden model does.
//
// What bounds K2: each unique B row segment that real slots reference read
// once, plus ja, va (4, 2 or 1 bytes a slot, and 4 bytes of scale a row for
// int8) and the output: at chip_smoke's S3 band (rows 512,
// rmax 256, k 131072, cb 4096) about 69K unique rows of 16 KiB, 1.14 GB, or
// 0.34 ms at 3.35 TB/s; at 0.5 flop per gathered byte it is bound by
// memory.  Reaching that bound needs a B row shared by two rows of the band
// to come from device memory once, so the design keeps a band's gathers in
// L2: the columns are cut into slabs of K2_SLAB = 64 floats, a block owns
// one ELL row and one slab, and the grid runs the rows fastest.  The blocks
// in flight then cover every row of the band on a few adjacent slabs, whose
// unique row segments (69K x 256 B = 18 MB a slab at S3) L2 holds, not the
// whole 2 GiB panel.  A block stages its row's ja/va (from L2 after the
// first slab) in shared memory, in chunks of K2_STAGE slots for the
// mega-rows.  Inside a block, K2_GROUPS slot groups of K2_QUADS lanes each
// take every K2_GROUPS-th slot, a lane loads one float4 of the segment (a
// scalar masked tail when cb % 4 != 0 or the buffers are not 16-byte
// aligned), and 8 gathers a lane are issued before their FMAs (the last
// batch predicated), so each block keeps about 16 KiB in flight.  The
// partial sums are added in group order through shared memory and each
// output element is stored once, times alpha.
//
// Measured on the card (PERF.md, Findings): at S3's band 64-column slabs
// beat 32 and 128, and a block per (row, slab) beats a block that walks all
// its row's slabs in order with its ja/va staged once, the first design:
// the walking rows drift apart and the slab loop drains the loads in
// flight at every slab.
//
// What bounds B6: the real slots' ja/va stream (x, k * 4 bytes, stays in
// L2).  A group of L lanes (4 to 32, about 8 slots a lane of rmax) owns a
// row; a lane loads 4 slots of ja and va at a time (one load each, 16, 8 or
// 4 bytes of va, when rmax % 4 == 0 and the buffers are aligned), issues
// their x gathers
// together, two quads ahead; a shuffle reduction within the group, then
// alpha and one store at y[rows[i]].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K2_THREADS = 128;   // K2 threads per block
constexpr int K2_QUADS = 16;      // float4 lanes across a slab
constexpr int K2_SLAB = 4 * K2_QUADS;              // slab width, columns
constexpr int K2_GROUPS = K2_THREADS / K2_QUADS;   // slot groups a block
constexpr int K2_STAGE = 1024;    // ja/va slots staged per shared-memory chunk
constexpr int K2_BATCH = 8;       // gathers issued per lane before their FMAs
constexpr int SPMV_THREADS = 256;

// va's element types: fp32, bf16 (its 16 bits) and int8, and 4 of them in
// one load.
template <typename V>
struct Quad4;
template <>
struct Quad4<float> {
  using T = float4;
};
template <>
struct Quad4<uint16_t> {
  using T = ushort4;
};
template <>
struct Quad4<int8_t> {
  using T = char4;
};

// v(i, s) in fp32: exact for fp32 and bf16; float(q) * scale, one rounding,
// for int8 (promote_ell_vals' arithmetic).  `scale` is read for int8 only.
__device__ __forceinline__ float value(float v, float) { return v; }
__device__ __forceinline__ float value(uint16_t v, float) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float value(int8_t v, float scale) {
  return __fmul_rn(static_cast<float>(v), scale);
}

__device__ __forceinline__ long long row_count(const int* counts, long long r,
                                               long long rmax) {
  if (!counts) return rmax;
  const long long c = counts[r];
  return c < 0 ? 0 : (c > rmax ? rmax : c);
}

template <bool VEC4>
__device__ __forceinline__ float4 gather(const float* __restrict__ b,
                                         long long off, long long c0,
                                         long long cb) {
  if (VEC4) return __ldg(reinterpret_cast<const float4*>(b + off + c0));
  const float* g = b + off + c0;
  float4 v;
  v.x = __ldg(g);
  v.y = c0 + 1 < cb ? __ldg(g + 1) : 0.f;
  v.z = c0 + 2 < cb ? __ldg(g + 2) : 0.f;
  v.w = c0 + 3 < cb ? __ldg(g + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& g) {
  acc.x = fmaf(v, g.x, acc.x);
  acc.y = fmaf(v, g.y, acc.y);
  acc.z = fmaf(v, g.z, acc.z);
  acc.w = fmaf(v, g.w, acc.w);
}

// Slots g, g + G, g + 2G, ... < n (G = K2_GROUPS) of the staged chunk,
// into acc, in batches of K2_BATCH gathers issued together (the last batch
// predicated, so a short tail does not wait out one load latency a slot).
template <bool VEC4>
__device__ __forceinline__ void accumulate(float4& acc,
                                           const float* __restrict__ b,
                                           const int* s_j, const float* s_v,
                                           int g, int n, long long c0,
                                           long long cb) {
  constexpr int G = K2_GROUPS;
  for (int s = g; s < n; s += K2_BATCH * G) {
    float4 v[K2_BATCH];
#pragma unroll
    for (int u = 0; u < K2_BATCH; ++u)
      if (s + u * G < n)
        v[u] = gather<VEC4>(b, (long long)s_j[s + u * G] * cb, c0, cb);
#pragma unroll
    for (int u = 0; u < K2_BATCH; ++u)
      if (s + u * G < n) fma4(acc, s_v[s + u * G], v[u]);
  }
}

template <typename Idx, typename V>
__device__ __forceinline__ void stage(int* s_j, float* s_v,
                                      const Idx* __restrict__ jrow,
                                      const V* __restrict__ vrow, float scale,
                                      long long s0, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_j[i] = (int)jrow[s0 + i];
    s_v[i] = value(vrow[s0 + i], scale);
  }
}

// grid (rows, slabs): block (i, y) owns ELL row i and columns
// [y * K2_SLAB, (y + 1) * K2_SLAB).
template <typename Idx, typename V, bool VEC4>
__global__ void __launch_bounds__(K2_THREADS)
spmm_ell_kernel(float* __restrict__ out, const float* __restrict__ b,
                const Idx* __restrict__ ja, const V* __restrict__ va,
                const float* __restrict__ va_scale,
                const int* __restrict__ counts,
                const int* __restrict__ rows_idx, float alpha,
                long long rmax, long long cb) {
  __shared__ int s_j[K2_STAGE];
  __shared__ float s_v[K2_STAGE];
  __shared__ float4 s_red[K2_GROUPS][K2_QUADS];

  const long long r = blockIdx.x;
  const int g = threadIdx.x / K2_QUADS;
  const int q = threadIdx.x % K2_QUADS;
  const long long cnt = row_count(counts, r, rmax);
  const Idx* jrow = ja + r * rmax;
  const V* vrow = va + r * rmax;
  const float scale = va_scale ? va_scale[r] : 1.f;
  const long long col0 = (long long)blockIdx.y * K2_SLAB;
  const long long c0 = col0 + 4 * q;
  const bool live = c0 < cb;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long s0 = 0; s0 < cnt; s0 += K2_STAGE) {
    const int n = (int)(cnt - s0 < K2_STAGE ? cnt - s0 : K2_STAGE);
    if (s0 > 0) __syncthreads();  // the chunk before is consumed
    stage(s_j, s_v, jrow, vrow, scale, s0, n);
    __syncthreads();
    if (live) accumulate<VEC4>(acc, b, s_j, s_v, g, n, c0, cb);
  }
  s_red[g][q] = acc;
  __syncthreads();
  if (threadIdx.x < K2_SLAB && col0 + threadIdx.x < cb) {
    float sum = 0.f;
#pragma unroll
    for (int gg = 0; gg < K2_GROUPS; ++gg)
      sum += reinterpret_cast<const float*>(s_red[gg])[threadIdx.x];
    out[(rows_idx ? (long long)rows_idx[r] : r) * cb + col0 + threadIdx.x] =
        alpha * sum;
  }
}

template <typename Idx>
struct Quad;  // 4 consecutive indices, one load
template <>
struct Quad<int32_t> {
  using T = int4;
};
template <>
struct Quad<uint16_t> {
  using T = ushort4;
};

// Slots [4 * qd, 4 * qd + 4) of a row with cnt real slots, into acc.
template <typename Idx, typename V, bool VEC>
__device__ __forceinline__ float quad_dot(const float* __restrict__ x,
                                          const Idx* __restrict__ jrow,
                                          const V* __restrict__ vrow,
                                          float scale, long long qd,
                                          long long cnt, float acc) {
  const long long s = qd * 4;
  int j0, j1, j2, j3;
  float v0, v1, v2, v3;
  if (VEC) {
    const auto jq = reinterpret_cast<const typename Quad<Idx>::T*>(jrow)[qd];
    const auto vq = reinterpret_cast<const typename Quad4<V>::T*>(vrow)[qd];
    j0 = jq.x, j1 = jq.y, j2 = jq.z, j3 = jq.w;
    v0 = value(static_cast<V>(vq.x), scale);
    v1 = value(static_cast<V>(vq.y), scale);
    v2 = value(static_cast<V>(vq.z), scale);
    v3 = value(static_cast<V>(vq.w), scale);
  } else {
    j0 = jrow[s], v0 = value(vrow[s], scale);
    j1 = s + 1 < cnt ? (int)jrow[s + 1] : 0;
    v1 = s + 1 < cnt ? value(vrow[s + 1], scale) : 0.f;
    j2 = s + 2 < cnt ? (int)jrow[s + 2] : 0;
    v2 = s + 2 < cnt ? value(vrow[s + 2], scale) : 0.f;
    j3 = s + 3 < cnt ? (int)jrow[s + 3] : 0;
    v3 = s + 3 < cnt ? value(vrow[s + 3], scale) : 0.f;
  }
  // the x gathers of the quad go out together; slots past cnt read no x
  const float x0 = __ldg(x + j0);
  const float x1 = s + 1 < cnt ? __ldg(x + j1) : 0.f;
  const float x2 = s + 2 < cnt ? __ldg(x + j2) : 0.f;
  const float x3 = s + 3 < cnt ? __ldg(x + j3) : 0.f;
  acc = fmaf(v0, x0, acc);
  if (s + 1 < cnt) acc = fmaf(v1, x1, acc);
  if (s + 2 < cnt) acc = fmaf(v2, x2, acc);
  if (s + 3 < cnt) acc = fmaf(v3, x3, acc);
  return acc;
}

// A group of L lanes per ELL row; groups past the last row compute nothing
// but stay for the shuffles, so every shuffle has its whole warp.
template <typename Idx, typename V, int L, bool VEC>
__global__ void __launch_bounds__(SPMV_THREADS)
spmv_ell_kernel(float* __restrict__ y, const float* __restrict__ x,
                const Idx* __restrict__ ja, const V* __restrict__ va,
                const float* __restrict__ va_scale,
                const int* __restrict__ counts,
                const int* __restrict__ rows_idx, float alpha, long long rows,
                long long rmax) {
  const long long r =
      ((long long)blockIdx.x * SPMV_THREADS + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  const bool live = r < rows;
  const long long cnt = live ? row_count(counts, r, rmax) : 0;
  const Idx* jrow = ja + (live ? r : 0) * rmax;
  const V* vrow = va + (live ? r : 0) * rmax;
  const float scale = va_scale && live ? va_scale[r] : 1.f;
  const long long nq = (cnt + 3) / 4;
  float a0 = 0.f, a1 = 0.f;
  long long qd = lane;
  for (; qd + L < nq; qd += 2 * L) {  // two quads in flight a lane
    a0 = quad_dot<Idx, V, VEC>(x, jrow, vrow, scale, qd, cnt, a0);
    a1 = quad_dot<Idx, V, VEC>(x, jrow, vrow, scale, qd + L, cnt, a1);
  }
  if (qd < nq) a0 = quad_dot<Idx, V, VEC>(x, jrow, vrow, scale, qd, cnt, a0);
  float acc = a0 + a1;
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, L);
  if (live && lane == 0)
    y[rows_idx ? (long long)rows_idx[r] : r] = alpha * acc;
}

template <typename Idx, typename V>
int launch_spmm(float* out, const float* b, const void* ja, const void* va,
                const float* va_scale, const int* counts, const int* rows_idx,
                float alpha, long long rows, long long rmax, long long cb,
                bool vec4, cudaStream_t s) {
  const long long slabs = (cb + K2_SLAB - 1) / K2_SLAB;
  if (slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((unsigned)rows, (unsigned)slabs);
  const Idx* j = static_cast<const Idx*>(ja);
  const V* v = static_cast<const V*>(va);
  if (vec4)
    spmm_ell_kernel<Idx, V, true><<<grid, K2_THREADS, 0, s>>>(
        out, b, j, v, va_scale, counts, rows_idx, alpha, rmax, cb);
  else
    spmm_ell_kernel<Idx, V, false><<<grid, K2_THREADS, 0, s>>>(
        out, b, j, v, va_scale, counts, rows_idx, alpha, rmax, cb);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch_spmm_v(float* out, const float* b, const void* ja, const void* va,
                  int va_kind, const float* va_scale, const int* counts,
                  const int* rows_idx, float alpha, long long rows,
                  long long rmax, long long cb, bool vec4, cudaStream_t s) {
  if (va_kind == 0)
    return launch_spmm<Idx, float>(out, b, ja, va, nullptr, counts, rows_idx,
                                   alpha, rows, rmax, cb, vec4, s);
  if (va_kind == 1)
    return launch_spmm<Idx, uint16_t>(out, b, ja, va, nullptr, counts,
                                      rows_idx, alpha, rows, rmax, cb, vec4,
                                      s);
  return launch_spmm<Idx, int8_t>(out, b, ja, va, va_scale, counts, rows_idx,
                                  alpha, rows, rmax, cb, vec4, s);
}

template <typename Idx, typename V, int L>
void launch_spmv(float* y, const float* x, const void* ja, const void* va,
                 const float* va_scale, const int* counts,
                 const int* rows_idx, float alpha, long long rows,
                 long long rmax, bool vec, cudaStream_t s) {
  const dim3 grid((unsigned)((rows * L + SPMV_THREADS - 1) / SPMV_THREADS));
  const Idx* j = static_cast<const Idx*>(ja);
  const V* v = static_cast<const V*>(va);
  if (vec)
    spmv_ell_kernel<Idx, V, L, true><<<grid, SPMV_THREADS, 0, s>>>(
        y, x, j, v, va_scale, counts, rows_idx, alpha, rows, rmax);
  else
    spmv_ell_kernel<Idx, V, L, false><<<grid, SPMV_THREADS, 0, s>>>(
        y, x, j, v, va_scale, counts, rows_idx, alpha, rows, rmax);
}

template <typename Idx, typename V>
void launch_spmv_l(float* y, const float* x, const void* ja, const void* va,
                   const float* va_scale, const int* counts,
                   const int* rows_idx, float alpha, long long rows,
                   long long rmax, bool vec, cudaStream_t s) {
  // about 8 slots a lane: 4 lanes up to rmax 32, a whole warp from 256
  const int lanes = rmax > 128 ? 32 : rmax > 64 ? 16 : rmax > 32 ? 8 : 4;
  if (lanes == 32)
    launch_spmv<Idx, V, 32>(y, x, ja, va, va_scale, counts, rows_idx, alpha,
                            rows, rmax, vec, s);
  else if (lanes == 16)
    launch_spmv<Idx, V, 16>(y, x, ja, va, va_scale, counts, rows_idx, alpha,
                            rows, rmax, vec, s);
  else if (lanes == 8)
    launch_spmv<Idx, V, 8>(y, x, ja, va, va_scale, counts, rows_idx, alpha,
                           rows, rmax, vec, s);
  else
    launch_spmv<Idx, V, 4>(y, x, ja, va, va_scale, counts, rows_idx, alpha,
                           rows, rmax, vec, s);
}

template <typename Idx>
void launch_spmv_v(float* y, const float* x, const void* ja, const void* va,
                   int va_kind, const float* va_scale, const int* counts,
                   const int* rows_idx, float alpha, long long rows,
                   long long rmax, bool vec, cudaStream_t s) {
  if (va_kind == 0)
    launch_spmv_l<Idx, float>(y, x, ja, va, nullptr, counts, rows_idx, alpha,
                              rows, rmax, vec, s);
  else if (va_kind == 1)
    launch_spmv_l<Idx, uint16_t>(y, x, ja, va, nullptr, counts, rows_idx,
                                 alpha, rows, rmax, vec, s);
  else
    launch_spmv_l<Idx, int8_t>(y, x, ja, va, va_scale, counts, rows_idx,
                               alpha, rows, rmax, vec, s);
}

}  // namespace

// out[rows_idx[i], :] = alpha * ELL(ja, va)[i] @ b for i < rows, launched on
// `stream` (a cudaStream_t).  out has cb columns (row stride cb); counts
// and rows_idx may be null (see the contract above).  ja_u16 selects uint16
// indices (else int32); va_kind 0, 1 or 2 says va holds fp32, bf16 or int8
// values, and va_scale (int8 only) one fp32 scale an ELL row.  vec4 may be
// set only when cb % 4 == 0 and b and out are 16-byte aligned.  rows must
// fit a grid's x dimension (2^31 - 1) and cb 65535 slabs.  Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidConfiguration for
// a cb that is too wide, cudaErrorInvalidValue for an unknown va_kind or an
// int8 va without scales): 0 when it was accepted.
extern "C" int bof_spmm_ell(float* out, const float* b, const void* ja,
                            int ja_u16, const void* va, int va_kind,
                            const float* va_scale, const int* counts,
                            const int* rows_idx, float alpha, long long rows,
                            long long rmax, long long cb, int vec4,
                            void* stream) {
  if (va_kind < 0 || va_kind > 2 || (va_kind == 2 && !va_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || cb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ja_u16)
    return launch_spmm_v<uint16_t>(out, b, ja, va, va_kind, va_scale, counts,
                                   rows_idx, alpha, rows, rmax, cb, vec4 != 0,
                                   s);
  return launch_spmm_v<int32_t>(out, b, ja, va, va_kind, va_scale, counts,
                                rows_idx, alpha, rows, rmax, cb, vec4 != 0, s);
}

// y[rows_idx[i]] = alpha * ELL(ja, va)[i] @ x for i < rows.  vec may be set
// only when rmax % 4 == 0 and va and ja are aligned to 4 of their elements.
// Otherwise the same conventions as bof_spmm_ell.
extern "C" int bof_spmv_ell(float* y, const float* x, const void* ja,
                            int ja_u16, const void* va, int va_kind,
                            const float* va_scale, const int* counts,
                            const int* rows_idx, float alpha, long long rows,
                            long long rmax, int vec, void* stream) {
  if (va_kind < 0 || va_kind > 2 || (va_kind == 2 && !va_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ja_u16)
    launch_spmv_v<uint16_t>(y, x, ja, va, va_kind, va_scale, counts, rows_idx,
                            alpha, rows, rmax, vec != 0, s);
  else
    launch_spmv_v<int32_t>(y, x, ja, va, va_kind, va_scale, counts, rows_idx,
                           alpha, rows, rmax, vec != 0, s);
  return static_cast<int>(cudaGetLastError());
}
