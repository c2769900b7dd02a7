// Probe mm_loop: out = cast(sum over iters of a @ b), summed in float32,
// with both operands resident in shared memory: the tensor-core rate of one
// product shape, taken per iteration inside one launch.
//
// Replaces tools/microbench_mm.py:16 mm_loop_kernel (the matrix-unit rate
// at a given shape, operands resident in VMEM).
//
// What bounds it: the tensor cores, 2 * M * K * N * iters operations at
// 989 TFLOP/s in bf16 (the panels are read from device memory once, which
// the iterations amortise).  The kernel measures what mma.sync reaches at
// the model's narrow shapes; wgmma, the only way to the full rate, is later
// work.
//
// Design.  Each block owns a BM x BN tile of the output: BM = 32 * WM rows
// and BN = 8 * NF * WN columns for WM x WN warps, each warp 32 rows by
// 8 * NF columns (two m16 tiles by NF n8 tiles, 8 * NF float32 sums a
// thread).  The block loads its A panel [BM][Kp] and B panel [Kp][BN] into
// shared memory once, zero-padded (K to Kp, a multiple of 16; rows past M
// and columns past N), then loops iters times over Kp in steps of 16:
// ldmatrix.x4 for each A fragment, ldmatrix.x2.trans for each B fragment
// (B is stored k-major), mma.sync.m16n8k16 bf16 -> f32.  Every row of both
// panels is an odd number of 16-byte units long, so the eight row addresses
// of one ldmatrix fall in distinct bank groups.  The ldmatrix asm is
// volatile: each iteration reads its operands from shared memory again, as
// the JAX kernel reads VMEM, rather than keeping them in registers.
#include "common.cuh"

namespace shiftnet {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row lengths of the panels in elements (ops/probes.py, mm_smem).
__host__ __device__ inline int mm_lda(int Kp) { return Kp + 8; }
__host__ __device__ inline int mm_ldb(int BN) {
  return BN + ((BN / 8) % 2 == 0 ? 8 : 16);
}

// rows x cols of src (row length ld_src, valid rows_ok x cols_ok) into
// shared memory (row length ld_dst), zero outside; 16-byte loads where a
// chunk of 8 lies inside and the source rows are 16-byte aligned.
__device__ __forceinline__ void load_panel(__nv_bfloat16* dst, int ld_dst,
                                           const __nv_bfloat16* src,
                                           long long ld_src, int rows,
                                           int cols, int rows_ok,
                                           int cols_ok) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const bool vec = ld_src % 8 == 0 &&
                   ((uintptr_t)src & 15) == 0;
  const int chunks = cols / 8;  // cols is a multiple of 8
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    __nv_bfloat16* d = dst + (size_t)r * ld_dst + c;
    const __nv_bfloat16* s = src + r * ld_src + c;
    if (vec && r < rows_ok && c + 8 <= cols_ok) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (r < rows_ok && c + j < cols_ok) ? s[j] : zero;
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(256)
    mm_loop_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   __nv_bfloat16* __restrict__ out, int M, int K, int N,
                   int Kp, int iters, int WN) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WM = blockDim.x / 32 / WN;
  const int BM = 32 * WM, BN = 8 * NF * WN;
  const int lda = mm_lda(Kp), ldb = mm_ldb(BN);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + (size_t)BM * lda;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  load_panel(As, lda, a + (size_t)m0 * K, K, BM, Kp, M - m0, K);
  load_panel(Bs, ldb, b + n0, N, Kp, BN, K, N - n0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / WN, wc = warp - wr * WN;
  const __nv_bfloat16* a_frag = As + (size_t)(wr * 32 + lane % 16) * lda +
                                (lane / 16) * 8;
  const __nv_bfloat16* b_frag = Bs + (size_t)(lane % 16) * ldb + wc * 8 * NF;
  float acc[2][NF][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int it = 0; it < iters; ++it) {
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      uint32_t af[2][4], bf[NF][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], a_frag + (size_t)mi * 16 * lda + k0);
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
        ldmatrix_x2_trans(bf[ni], b_frag + (size_t)k0 * ldb + ni * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NF; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // Accumulator layout of m16n8: c0, c1 at (lane / 4, 2 * (lane % 4) + j),
  // c2, c3 eight rows below.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = m0 + wr * 32 + mi * 16 + h * 8 + lane / 4;
          const int c = n0 + wc * 8 * NF + ni * 8 + 2 * (lane % 4) + j;
          if (r < M && c < N)
            out[(size_t)r * N + c] = __float2bfloat16(acc[mi][ni][2 * h + j]);
        }
}

template <int NF>
static int launch_mm_loop(const void* a, const void* b, void* out, int M,
                          int K, int N, int iters, int WM, int WN,
                          cudaStream_t stream) {
  const int Kp = (K + 15) / 16 * 16;
  const int BM = 32 * WM, BN = 8 * NF * WN;
  const size_t smem =
      2 * ((size_t)BM * mm_lda(Kp) + (size_t)Kp * mm_ldb(BN));
  cudaFuncSetAttribute(mm_loop_kernel<NF>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_loop_kernel<NF><<<grid, 32 * WM * WN, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      M, K, N, Kp, iters, WN);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// a: (M, K), b: (K, N), out: (M, N), all bf16 and contiguous; NF in 1..4
// n8 tiles a warp, WM x WN warps a block (WM * WN <= 8).
extern "C" int shiftnet_mm_loop(const void* a, const void* b, void* out, int M,
                                int K, int N, int iters, int NF, int WM,
                                int WN, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (WM < 1 || WN < 1 || WM * WN > 8) return (int)cudaErrorInvalidValue;
  switch (NF) {
    case 1: return launch_mm_loop<1>(a, b, out, M, K, N, iters, WM, WN, st);
    case 2: return launch_mm_loop<2>(a, b, out, M, K, N, iters, WM, WN, st);
    case 3: return launch_mm_loop<3>(a, b, out, M, K, N, iters, WM, WN, st);
    case 4: return launch_mm_loop<4>(a, b, out, M, K, N, iters, WM, WN, st);
  }
  return (int)cudaErrorInvalidValue;
}
