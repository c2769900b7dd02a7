// Hopper's Tensor Memory Accelerator (TMA): tensor maps, the copies between
// device memory and shared memory, and the mbarriers that report them.
//
// Host: encode_tiled builds a CUtensorMap, the descriptor of a tiled copy:
// a tensor of rank 2-5 (dimension 0 innermost, in elements), its strides in
// bytes, and the box a copy moves.  The TMA unit computes every address
// from it and the box's element coordinates, so a box may start at any
// element; elements of a box outside the tensor are read as zeros and are
// not written.  What the driver refuses: a global base not 16-byte aligned,
// a stride not a multiple of 16 bytes (or not under 2^40), a box dimension
// over 256, a box row (dimension 0) not a multiple of 16 bytes.
//
// Binding: cuTensorMapEncodeTiled is a driver-API function, and the kernel
// library links only the CUDA runtime, so its address comes from
// cudaGetDriverEntryPoint (the type from <cudaTypedefs.h>) instead of
// linking libcuda.
//
// Device: a map is read from kernel parameter space (a `const
// __grid_constant__` parameter, or a field of one) or from device memory;
// one written into device memory by a copy before the launch needs
// tensormap_acquire before its first use.  A load completes on an mbarrier
// (mbar_expect_tx, then tma_load_*; the waiter calls mbar_wait with the
// barrier's phase parity); a store is tracked by bulk groups (tma_store_*,
// bulk_commit, bulk_wait_read / bulk_wait_all).  Shared memory written with
// ordinary stores must be fenced (fence_proxy_async, then a block barrier)
// before a TMA store reads it, or the store may read stale data.  Shared
// memory boxes are 128-byte aligned.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace shiftnet {
namespace tma {

// The driver's cuTensorMapEncodeTiled, looked up once; null if the driver
// does not have it.
inline PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions over `base`: dims in elements,
// strides in bytes of dimensions 1 .. rank - 1, box in elements; no
// interleave, zeros outside the tensor, and the shared-memory swizzle
// `swizzle` (none by default).  Under CU_TENSOR_MAP_SWIZZLE_128B a box row
// (dimension 0) is at most 128 bytes, and the 16-byte unit u of the box's
// row r lands at unit u ^ (r % 8) of that row, counted from a 1024-byte
// aligned destination (wgmma.cuh reads it so).  Returns the CUDA driver's
// CUresult (CUDA_SUCCESS is 0), or CUDA_ERROR_NOT_FOUND without the entry
// point.
inline int encode_tiled(
    CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  PFN_cuTensorMapEncodeTiled fn = encoder();
  if (!fn) return (int)CUDA_ERROR_NOT_FOUND;
  const uint32_t ones[5] = {1, 1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                 const_cast<void*>(base), dims, strides, box, ones,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A map's generic address, as the copy instructions take it.
__device__ __forceinline__ uint64_t map_addr(const CUtensorMap* map) {
  return reinterpret_cast<uint64_t>(map);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the other threads and to the
// TMA unit (then a block barrier).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of copies to land on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A map written into device memory by a copy before the launch: order
// that write before the TMA unit's reads of the map.
__device__ __forceinline__ void tensormap_acquire(const CUtensorMap* map) {
  asm volatile(
      "fence.proxy.tensormap::generic.acquire.sys [%0], 128;\n" ::"l"(
          map_addr(map))
      : "memory");
}

// Load the box at element coordinates (c0, c1) of a 2-D map into shared
// memory at `dst`; it completes on barrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map_addr(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Store the box at `src` in shared memory to coordinates (c0, c1, c2) of a
// 3-D map; elements outside the map are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0,
                                             int c1, int c2, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(map_addr(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until every committed store group has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's ordinary shared-memory writes before later TMA
// (async proxy) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tma
}  // namespace shiftnet
