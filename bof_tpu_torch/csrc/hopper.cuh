// PTX and TMA helpers shared by the port's Hopper kernels (matmul_tf32.cu,
// matmul_lowp.cu, kmeans.cu): shared-memory addresses, mbarriers, TMA tile
// loads, wgmma descriptors and fences, the tensor-map encoder fetched from
// the driver at run time (so no library needs -lcuda), and the 3xTF32
// pieces that K1's fp32 kernel and B7's assign kernel share: the split
// pass, the fp32 tensor maps and one ring stage's three tf32 products.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver API's types; not linked
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Spins until the barrier's phase `parity` has completed.  A wait that
// outlasts about a minute of SM clocks traps, so a pipeline fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1LL << 37)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One box of a 2-D tensor map into shared memory; completion is reported to
// `bar` as transferred bytes.  c0 is the inner (K) coordinate.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile whose rows are ROW_BYTES (32,
// 64 or 128) long and swizzled as TMA's swizzle of that width writes them,
// at shared address `saddr` (the tile aligned to its 8-row swizzle atom):
// start address, LBO (unused when K-major and swizzled), SBO = one 8-row
// atom, layout type.  Adding n to it moves the start 16n bytes along K.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  static_assert(ROW_BYTES == 32 || ROW_BYTES == 64 || ROW_BYTES == 128,
                "wgmma swizzles rows of 32, 64 or 128 bytes");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * ROW_BYTES) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators while a wgmma owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda; null when the driver does not have it.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &q);
#endif
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// TMA reads a 2-D operand where it lies when its base is 16-byte aligned
// and its rows are a multiple of 16 bytes apart.
inline bool tma_ok(const void* p, long long ld, int size) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * size) % 16 == 0;
}

// ------------------------------------------------------------------ 3xTF32
//
// A K-major fp32 operand x is read as hi = x (wgmma truncates a raw fp32
// operand to TF32: the 13 low mantissa bits dropped, which chip_smoke.py
// probes) and lo = x - tf32(x), exact in fp32.  The three products
// lo*hi + hi*lo + hi*hi lose only lo*lo (about 2^-22 relative).  Tiles are
// BK floats of K (BK 16 or 32: one 64- or 128-byte swizzled row) by 64n
// rows.

constexpr int TF32_WK = 8;  // K of one tf32 wgmma

// x truncated to TF32.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// wgmma descriptor of a K-major fp32 tile with rows of BK floats, swizzled
// as TMA wrote them (tf32_kmajor_map).
template <int BK>
__device__ __forceinline__ uint64_t tf32_desc(uint32_t saddr) {
  return smem_desc<BK * 4>(saddr);
}

// d = A(64x8) * B(8x128) + (accumulate ? d : 0), tf32 in, fp32 out, both
// operands K-major in shared memory, for the executing warpgroup.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " %64, %65, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One ring stage of 3xTF32 for the executing warpgroup: acc (the fp32
// fragment of 64 rows x 128*NH columns) += P Q^T over BK of K, where
// px/pl are the descriptors of P's 64-row hi and lo tiles and qx/ql of Q's
// 128*NH-row ones.  The stage's three passes go into a fresh tensor-core
// accumulator, 128 columns at a time, which is then added to acc on the
// CUDA cores: the tensor cores' own fp32 accumulation drops low bits (on
// the H100 one TF32 pass at K 8192 ends about 2e-5 * max|C| from cuBLAS's
// fp32 sum), and a sum that never grows beyond one stage's BK terms keeps
// that loss at fp32's level.  Returns when the stage's wgmmas are done.
template <int NH, int BK>
__device__ __forceinline__ void tf32x3_stage(float (&acc)[64 * NH],
                                             uint64_t px, uint64_t qx,
                                             uint64_t pl, uint64_t ql) {
  float part[64];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const uint64_t half = (h * 128 * BK * 4) >> 4;  // Q rows 128h..
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / TF32_WK; ++kk) {
      const uint64_t step = (kk * TF32_WK * 4) >> 4;  // 16-byte units
      // the small terms first; the first product overwrites part
      wgmma_m64n128k8_tf32(part, pl + step, qx + half + step, kk > 0);
      wgmma_m64n128k8_tf32(part, px + step, ql + half + step, 1);
      wgmma_m64n128k8_tf32(part, px + step, qx + half + step, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[64 * h + i] += part[i];
  }
}

// Tensor map of a K-major (rows x K) fp32 operand with leading dimension ld,
// cut into boxes of box_rows x box_k (16 or 32 floats) with the swizzle of
// that row width (64 or 128 bytes); out-of-bounds elements of a box read
// as zero.
inline bool tf32_kmajor_map(CUtensorMap* map, const float* base, int rows,
                            int K, long long ld, int box_rows, int box_k) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_k == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The split pass's kernels and host functions are static: each file that
// includes this compiles and registers its own copy.

// The split pass for one operand of `rows` x K logical elements (rows of C
// or columns of C, K inner).  Reads it in storage order (TRANS: stored
// (K, rows); else (rows, K)), and writes K-major copies with leading
// dimension ldo: the operand itself (WRITE_X) and lo = x - tf32_hi(x)
// (WRITE_LO).  32 x 32 tiles, 1-D grid; the shared tile makes both the
// reads and the writes of a transpose contiguous across a warp.
template <bool TRANS, bool WRITE_X, bool WRITE_LO>
static __global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ src, long long lds,
                  float* __restrict__ x_out, float* __restrict__ lo_out,
                  long long ldo, int rows, int K) {
  __shared__ float tile[32][33];
  const int ktiles = (K + 31) / 32;
  const int r0 = (blockIdx.x / ktiles) * 32;
  const int k0 = (blockIdx.x % ktiles) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int j = ty; j < 32; j += 8) {
    if (TRANS) {  // tile[k][r]
      const int k = k0 + j, r = r0 + tx;
      tile[j][tx] = (k < K && r < rows) ? src[(long long)k * lds + r] : 0.f;
    } else {  // tile[r][k]
      const int r = r0 + j, k = k0 + tx;
      tile[j][tx] = (r < rows && k < K) ? src[(long long)r * lds + k] : 0.f;
    }
  }
  if (TRANS) __syncthreads();
#pragma unroll
  for (int j = ty; j < 32; j += 8) {
    const int r = r0 + j, k = k0 + tx;
    if (r < rows && k < K) {
      const float v = TRANS ? tile[tx][j] : tile[j][tx];
      if (WRITE_X) x_out[(long long)r * ldo + k] = v;
      if (WRITE_LO) lo_out[(long long)r * ldo + k] = v - tf32_hi(v);
    }
  }
}

template <bool TRANS, bool WRITE_X, bool WRITE_LO>
static void tf32_split(const float* src, long long lds, float* x_out,
                       float* lo_out, long long ldo, int rows, int K,
                       cudaStream_t s) {
  const long long blocks = (long long)((rows + 31) / 32) * ((K + 31) / 32);
  tf32_split_kernel<TRANS, WRITE_X, WRITE_LO><<<(unsigned)blocks, 256, 0, s>>>(
      src, lds, x_out, lo_out, ldo, rows, K);
}

// One operand of `rows` x K as a 3xTF32 (passes 3) or one-pass TF32 product
// reads it: K-major, at *x with leading dimension *ld, and its lo part (in
// lo_ws at ldw) when passes == 3.  The split pass writes a K-major copy to
// x_ws (at ldw, a multiple of 4) when the storage is not K-major or TMA
// cannot read it where it lies (tma_ok), and lo from the same read.
// Returns false when a workspace it needs is missing.
static inline bool tf32_prepare(const float* src, long long lds,
                                bool kmajor, int rows, int K, int passes,
                                float* x_ws, float* lo_ws, long long ldw,
                                const float** x, long long* ld,
                                cudaStream_t s) {
  const bool lo = passes == 3;
  const bool copy = !kmajor || !tma_ok(src, lds, 4);
  if ((copy && (x_ws == nullptr || !tma_ok(x_ws, ldw, 4))) ||
      (lo && (lo_ws == nullptr || !tma_ok(lo_ws, ldw, 4))))
    return false;
  *x = copy ? x_ws : src;
  *ld = copy ? ldw : lds;
  if (!copy) {
    if (lo) tf32_split<false, false, true>(src, lds, nullptr, lo_ws, ldw, rows,
                                           K, s);
  } else if (kmajor) {
    if (lo) tf32_split<false, true, true>(src, lds, x_ws, lo_ws, ldw, rows, K,
                                          s);
    else tf32_split<false, true, false>(src, lds, x_ws, nullptr, ldw, rows, K,
                                        s);
  } else {
    if (lo) tf32_split<true, true, true>(src, lds, x_ws, lo_ws, ldw, rows, K,
                                         s);
    else tf32_split<true, true, false>(src, lds, x_ws, nullptr, ldw, rows, K,
                                       s);
  }
  return true;
}

}  // namespace hopper
