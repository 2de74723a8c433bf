// ELL sparse x dense products for the out-of-core sparse kernels.
//
// bof_spmm_ell_f32 (K2): out[r, :] = sum_s va[r, s] * B[ja[r, s], :]
//   Replaces bof_tpu/sparse/spmm_pallas.py:spmm_ell_pallas (the Pallas
//   VMEM-gather kernel) and its XLA twin bof_tpu/sparse/spmm_device.py:
//   ell_gather_reduce, which compute the same function: the device block
//   product of csrmm 'N'.
// bof_spmv_ell_f32 (B6): y[r] = sum_s va[r, s] * x[ja[r, s]]
//   Replaces the XLA step bof_tpu/sparse/spmm_device.py:spmv_ell_block, the
//   device block product of csrgemv 'N'.
//
// Layouts, as the planners build them (sparse/spmm_device.py:to_ell_rows):
// B is a row-major (k, cb) fp32 panel; ja and va are row-major (rows, rmax)
// ELL blocks, ja int32 or uint16 (the narrow link dtype, widened here in
// registers, never on the host), va fp32; padding slots carry ja = 0,
// va = 0 and are multiplied like any other slot, as the reference's
// va * B[ja] is.  Indices must lie in [0, k); the planner guarantees it.
// Offsets are 64-bit: ja * cb and rows * cb pass 2^31 on large panels.
//
// What bounds K2: every slot reads one B row segment of 4 * cb bytes for
// 2 * cb flops, so the kernel moves rows_pad * rmax * cb * 4 gathered bytes
// at 0.5 flop per byte; it is bound by memory.  At the paper's Fig. 6 shape
// (cb 4096, bands of 512 rows x rmax 256) one band gathers 2 GiB out of a
// 2 GiB B panel, far above the 50 MB L2, so the gathers come from HBM
// (3.35 TB/s: about 0.64 ms per band at best).  The design keeps every
// gathered byte in use: a block owns one ELL row and a chunk of up to 512
// columns, each thread owns 4 contiguous columns and reads them as one
// float4 (cb % 4 == 0 and 16-byte aligned buffers; otherwise a scalar path
// with a masked tail, so any cb works), so each gather is a coalesced run of
// up to 2 KiB.  The row's ja/va are staged through shared memory in chunks
// of STAGE slots (rmax is unbounded: a mega-row gets a band of its own with
// rmax up to the planner's entry_cap), the slot loop is unrolled so several
// gathers are in flight per thread, the sum is fp32 fmaf in slot order, and
// each output element is stored once.
//
// What bounds B6: 4 bytes of x per slot (plus 8 of ja/va); a warp per row
// with lanes striding over slots reads ja/va coalesced, then a shuffle
// reduction.  x (k * 4 bytes) mostly stays in L2.
//
// Later work (ROADMAP): skip padding slots or consume CSR row blocks
// directly (the ELL padding exists because scatter serializes on a TPU),
// keep small panels in shared memory, and an fp64 variant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGE = 256;        // ja/va slots staged per shared-memory chunk
constexpr int MAX_THREADS = 128;  // K2 threads per block: 512 columns
constexpr int SPMV_THREADS = 256; // B6: 8 rows (warps) per block

template <typename Idx, bool VEC4>
__global__ void __launch_bounds__(MAX_THREADS)
spmm_ell_kernel(float* __restrict__ out, const float* __restrict__ b,
                const Idx* __restrict__ ja, const float* __restrict__ va,
                long long rmax, long long cb) {
  __shared__ long long s_off[STAGE];
  __shared__ float s_va[STAGE];

  const long long r = blockIdx.x;
  const long long c0 =
      ((long long)blockIdx.y * blockDim.x + threadIdx.x) * 4;
  const Idx* jrow = ja + r * rmax;
  const float* vrow = va + r * rmax;
  const bool live = c0 < cb;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;

  for (long long s0 = 0; s0 < rmax; s0 += STAGE) {
    const int n = (int)(rmax - s0 < STAGE ? rmax - s0 : STAGE);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_off[i] = (long long)jrow[s0 + i] * cb;
      s_va[i] = vrow[s0 + i];
    }
    __syncthreads();
    if (live) {
      if (VEC4) {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(b + s_off[i] + c0));
          const float v = s_va[i];
          acc0 = fmaf(v, g.x, acc0);
          acc1 = fmaf(v, g.y, acc1);
          acc2 = fmaf(v, g.z, acc2);
          acc3 = fmaf(v, g.w, acc3);
        }
      } else {
        const int w = (int)(cb - c0 < 4 ? cb - c0 : 4);
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const float* g = b + s_off[i] + c0;
          const float v = s_va[i];
          acc0 = fmaf(v, __ldg(g), acc0);
          if (w > 1) acc1 = fmaf(v, __ldg(g + 1), acc1);
          if (w > 2) acc2 = fmaf(v, __ldg(g + 2), acc2);
          if (w > 3) acc3 = fmaf(v, __ldg(g + 3), acc3);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged slots
  }

  if (!live) return;
  float* orow = out + r * cb + c0;
  if (VEC4) {
    *reinterpret_cast<float4*>(orow) = make_float4(acc0, acc1, acc2, acc3);
  } else {
    const long long w = cb - c0;
    orow[0] = acc0;
    if (w > 1) orow[1] = acc1;
    if (w > 2) orow[2] = acc2;
    if (w > 3) orow[3] = acc3;
  }
}

template <typename Idx>
__global__ void __launch_bounds__(SPMV_THREADS)
spmv_ell_kernel(float* __restrict__ y, const float* __restrict__ x,
                const Idx* __restrict__ ja, const float* __restrict__ va,
                long long rows, long long rmax) {
  const long long r =
      (long long)blockIdx.x * (SPMV_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together: the shuffles stay full
  const Idx* jrow = ja + r * rmax;
  const float* vrow = va + r * rmax;
  float acc = 0.f;
  for (long long s = lane; s < rmax; s += 32)
    acc = fmaf(vrow[s], __ldg(x + (long long)jrow[s]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[r] = acc;
}

template <typename Idx>
void launch_spmm(float* out, const float* b, const void* ja, const float* va,
                 long long rows, long long rmax, long long cb, bool vec4,
                 cudaStream_t s) {
  const long long quads = (cb + 3) / 4;  // column groups of 4
  int threads = (int)((quads + 31) / 32 * 32);
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const long long chunks = (quads + threads - 1) / threads;
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  const Idx* j = static_cast<const Idx*>(ja);
  if (vec4)
    spmm_ell_kernel<Idx, true><<<grid, threads, 0, s>>>(out, b, j, va, rmax, cb);
  else
    spmm_ell_kernel<Idx, false><<<grid, threads, 0, s>>>(out, b, j, va, rmax, cb);
}

}  // namespace

// out (rows, cb) = ELL(ja, va) @ b, launched on `stream` (a cudaStream_t).
// ja_u16 selects uint16 indices (else int32); vec4 may be set only when
// cb % 4 == 0 and b and out are 16-byte aligned.  rows must fit a grid's x
// dimension (2^31 - 1).  Returns cudaGetLastError() after the launch: 0 when
// the kernel was accepted.
extern "C" int bof_spmm_ell_f32(float* out, const float* b, const void* ja,
                                int ja_u16, const float* va, long long rows,
                                long long rmax, long long cb, int vec4,
                                void* stream) {
  if (rows <= 0 || cb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmax <= 0) return static_cast<int>(
      cudaMemsetAsync(out, 0, (size_t)(rows * cb) * sizeof(float), s));
  if (ja_u16)
    launch_spmm<uint16_t>(out, b, ja, va, rows, rmax, cb, vec4 != 0, s);
  else
    launch_spmm<int32_t>(out, b, ja, va, rows, rmax, cb, vec4 != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// y (rows,) = ELL(ja, va) @ x.  Same conventions as bof_spmm_ell_f32.
extern "C" int bof_spmv_ell_f32(float* y, const float* x, const void* ja,
                                int ja_u16, const float* va, long long rows,
                                long long rmax, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmax <= 0) return static_cast<int>(
      cudaMemsetAsync(y, 0, (size_t)rows * sizeof(float), s));
  const dim3 grid((unsigned)((rows + SPMV_THREADS / 32 - 1) / (SPMV_THREADS / 32)));
  if (ja_u16)
    spmv_ell_kernel<uint16_t><<<grid, SPMV_THREADS, 0, s>>>(
        y, x, static_cast<const uint16_t*>(ja), va, rows, rmax);
  else
    spmv_ell_kernel<int32_t><<<grid, SPMV_THREADS, 0, s>>>(
        y, x, static_cast<const int32_t*>(ja), va, rows, rmax);
  return static_cast<int>(cudaGetLastError());
}
