// Probe mm_loop: out = cast(sum over iters of a @ b), summed in float32,
// with both operands resident in shared memory: the tensor-core rate of one
// product shape, taken per iteration inside one launch.
//
// Replaces tools/microbench_mm.py:16 mm_loop_kernel (the matrix-unit rate
// at a given shape, operands resident in VMEM).
//
// What bounds it: the tensor cores, 2 * M * K * N * iters operations at
// 989 TFLOP/s in bf16 (the panels are read from device memory once, which
// the iterations amortise), and below N = 64 the shared-memory reads of
// wgmma's operands (wgmma.cuh).
//
// Design.  Each block owns a BM x BN tile of the output, BM = 64 rows for
// each of its one or two warpgroups, BN one of the wgmma widths the
// planner uses (ops/probes.py, mm_plan, which also computes every byte
// offset below).  Both panels stay in shared memory for all iterations,
// as they lie in memory: A as [chunk][BM][64 k], K-major, B as
// [chunk][64-column box][64 k][64 n], N-major; B is never transposed, the
// transpose bit of wgmma reads it as it is.  Thread 0 issues the TMA loads
// of the whole panels, K-chunk by K-chunk (64 k: a 128-byte swizzle row),
// each chunk on its own mbarrier, with the tensor maps' 128-byte swizzle;
// the maps' bounds fill zeros past K, M and N, so the kernel has no
// padding code.  A box wholly past N is not loaded (its columns are never
// stored).  Each warpgroup waits for a chunk only in the first iteration,
// then issues its wgmma.mma_async m64nBNk16 products, up to 4 a chunk
// (ceil(K / 16) in all, not Kp / 16), committed a chunk a group with one
// group left in flight, into BN / 2 float32 registers a thread; it waits
// for all only before the epilogue, which rounds each sum to bf16 once and
// stores pairs of columns, masked at M and N.  No stage ring: the operands
// are resident by definition.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace shiftnet {

constexpr int kMmChunk = 64;      // k a chunk: one 128-byte swizzle row
constexpr int kMmAtom = 8192;     // one B box: 64 k rows of 128 bytes
constexpr int kMmSmem = 232448;   // the most a block may have

// Byte offsets of the panels from the 1024-byte aligned base of shared
// memory and the descriptors' fields, from ops/probes.py, MmPlan.
struct MmArgs {
  __nv_bfloat16* out;
  int M, N, iters, chunks, ksteps, atoms;
  uint32_t a_chunk, b_chunk, b_off, bar_off, a_wg, a_k, b_k, a_sbo, b_lbo,
      b_sbo;
};

template <int BN, int WGS>
__global__ void __launch_bounds__(128 * WGS)
    mm_loop_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const MmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (tma::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_s = base, b_s = base + p.b_off, bars = base + p.bar_off;
  const int m0 = blockIdx.y * 64 * WGS, n0 = blockIdx.x * BN;
  const int atoms = min(p.atoms, (p.N - n0 + 63) / 64);  // inside N
  if (threadIdx.x == 0) {
    for (int c = 0; c < p.chunks; ++c) tma::mbar_init(bars + 8 * c, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < p.chunks; ++c) {
      const uint32_t bar = bars + 8 * c;
      tma::mbar_expect_tx(bar, p.a_chunk + atoms * kMmAtom);
      tma::tma_load_2d(a_s + c * p.a_chunk, &a_map, kMmChunk * c, m0, bar);
      for (int j = 0; j < atoms; ++j)
        tma::tma_load_2d(b_s + c * p.b_chunk + j * kMmAtom, &b_map,
                         n0 + 64 * j, kMmChunk * c, bar);
    }
  }
  __syncwarp();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint64_t da0 = wgmma::desc(a_s + wg * p.a_wg, 16, p.a_sbo);
  const uint64_t db0 = wgmma::desc(b_s, p.b_lbo, p.b_sbo);
  for (int it = 0; it < p.iters; ++it) {
    for (int c = 0; c < p.chunks; ++c) {
      if (it == 0) tma::mbar_wait(bars + 8 * c, 0);
      const int steps = min(4, p.ksteps - 4 * c);
      wgmma::fence_operands<BN / 2>(acc);
      wgmma::fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < steps)  // descriptors advance by the offset >> 4
          wgmma::mma_m64k16<BN>(
              acc, da0 + ((c * p.a_chunk + s * p.a_k) >> 4),
              db0 + ((c * p.b_chunk + s * p.b_k) >> 4));
      }
      wgmma::commit();
      wgmma::wait<1>();
      wgmma::fence_operands<BN / 2>(acc);
    }
  }
  wgmma::wait<0>();
  wgmma::fence_operands<BN / 2>(acc);

  const int row0 = m0 + 64 * wg;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = row0 + wgmma::acc_row(i, t);
    const int c = n0 + wgmma::acc_col(i, t);  // even; N is a multiple of 8
    if (r < p.M && c < p.N)
      *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)r * p.N + c) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int BN, int WGS>
static int launch_mm_loop(const CUtensorMap& am, const CUtensorMap& bm,
                          const MmArgs& p, int smem, cudaStream_t st) {
  static const bool sized = [] {  // dynamic shared memory past 48 KB
    cudaFuncSetAttribute(mm_loop_kernel<BN, WGS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMmSmem);
    return true;
  }();
  (void)sized;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + 64 * WGS - 1) / (64 * WGS));
  mm_loop_kernel<BN, WGS><<<grid, 128 * WGS, smem, st>>>(am, bm, p);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// a: (M, K), b: (K, N), out: (M, N), all bf16, contiguous and 16-byte
// aligned, K and N multiples of 8.  plan (ops/probes.py, MmPlan.args): BM,
// BN, chunks, k-steps, boxes of B a chunk, then in bytes the A chunk, the
// B chunk, B's offset, the barriers' offset, the shared memory of a block,
// a warpgroup's rows of A, a k-step of A and of B, A's SBO, B's LBO and
// SBO.  Returns the cudaError_t of the launch, or 10000 + the CUresult of
// a map the CUDA driver refused to encode.
extern "C" int shiftnet_mm_loop(const void* a, const void* b, void* out,
                                int M, int K, int N, int iters,
                                const long long* plan, void* stream) {
  using namespace shiftnet;
  const int bm = (int)plan[0], bn = (int)plan[1];
  MmArgs p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.N = N;
  p.iters = iters;
  p.chunks = (int)plan[2];
  p.ksteps = (int)plan[3];
  p.atoms = (int)plan[4];
  p.a_chunk = (uint32_t)plan[5];
  p.b_chunk = (uint32_t)plan[6];
  p.b_off = (uint32_t)plan[7];
  p.bar_off = (uint32_t)plan[8];
  const long long smem = plan[9];
  p.a_wg = (uint32_t)plan[10];
  p.a_k = (uint32_t)plan[11];
  p.b_k = (uint32_t)plan[12];
  p.a_sbo = (uint32_t)plan[13];
  p.b_lbo = (uint32_t)plan[14];
  p.b_sbo = (uint32_t)plan[15];
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8 || iters < 1 ||
      (bm != 64 && bm != 128) || p.chunks != (K + kMmChunk - 1) / kMmChunk ||
      p.ksteps != (K + 15) / 16 || p.atoms != (bn + 63) / 64 ||
      p.a_chunk != 128u * bm || p.b_chunk != (uint32_t)p.atoms * kMmAtom ||
      p.b_off % 1024 || p.bar_off < p.b_off + p.chunks * p.b_chunk ||
      smem > kMmSmem || smem < 1024 + p.bar_off + 8 * p.chunks ||
      ((uintptr_t)a & 15) || ((uintptr_t)b & 15))
    return (int)cudaErrorInvalidValue;
  // A: (K, M) innermost first, a box of 64 k by BM rows; B: (N, K), a box
  // of 64 n by 64 k; both with the 128-byte swizzle wgmma reads.
  CUtensorMap am, bmap;
  const uint64_t adims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t astride[1] = {2ULL * K};
  const uint32_t abox[2] = {kMmChunk, (uint32_t)bm};
  int err = tma::encode_tiled(&am, a, 2, adims, astride, abox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return 10000 + err;
  const uint64_t bdims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t bstride[1] = {2ULL * N};
  const uint32_t bbox[2] = {64, kMmChunk};
  err = tma::encode_tiled(&bmap, b, 2, bdims, bstride, bbox,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return 10000 + err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = (int)smem;
#define SHIFTNET_MM_CASE(BN)                                              \
  case BN:                                                                \
    return bm == 64 ? launch_mm_loop<BN, 1>(am, bmap, p, s, st)           \
                    : launch_mm_loop<BN, 2>(am, bmap, p, s, st);
  switch (bn) {  // ops/probes.py, MM_WIDTHS
    SHIFTNET_MM_CASE(24)
    SHIFTNET_MM_CASE(32)
    SHIFTNET_MM_CASE(64)
    SHIFTNET_MM_CASE(96)
    SHIFTNET_MM_CASE(128)
    SHIFTNET_MM_CASE(160)
  }
#undef SHIFTNET_MM_CASE
  return (int)cudaErrorInvalidValue;
}
