// PTX and TMA helpers shared by the port's Hopper kernels (matmul_tf32.cu,
// matmul_lowp.cu): shared-memory addresses, mbarriers, TMA tile loads,
// wgmma descriptors and fences, and the tensor-map encoder fetched from
// the driver at run time (so no library needs -lcuda).
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

}  // namespace hopper
