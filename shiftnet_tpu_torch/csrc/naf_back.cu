// Kernel H, naf_back: the end of a CAB2 / CAB1 gated block,
//
//   out = y + beta * (w7 . (s * ca) + b7),
//
// the channel-attention scale, the 1x1 projection n -> n, the learned
// residual scale beta and the shortcut.  Replaces
// shiftnet_tpu/ops/naf_chw.py:_naf_back_kernel (naf_cab_chw).  As in the
// XLA twin naf_cab_chw_xla, s * ca is a product in the compute type; the
// projection, bias, scale and residual are float32 and the result is cast
// once.  b7 is optional (the denoise variants' biased projection).
//
// The projection runs on the tensor cores (conv_core.cuh, cm_tile: mma.sync
// m16n8k16 in bfloat16, 3xTF32 in float32) over channel-major tiles, so a
// tile comes in from the NCHW planes as plain 16-byte cp.async copies, with
// no transposition: a tile is P = kBackPx consecutive pixels of one
// frame's plane (no halo), s and y as [n][cm_pitch(P)], and ca; s * ca is
// taken on the A fragments in registers.  The weight panel w7_p
// [n][mma_pitch(n)] (packed once in the compute type, ops/naf_chw.py,
// prep_naf) is loaded once per block: blocks are persistent, each walking
// over (frame, tile) jobs in two stages, the next job's s, y and ca in
// flight while this one's products, epilogue and stores run.  The epilogue
// adds b7, scales by beta (both kept in registers for the thread's
// channels) and adds y in float32, over y's tile in shared memory, which
// then goes out as 16-byte stores.  Every element of y is read (copied in)
// before the same element of out is written, and s is a separate tensor,
// so out may alias y.  ops/naf_chw.py, naf_back_smem, mirrors the sizes.
//
// What bounds it: its bytes, s and y read and out written, 3n values a
// pixel (480 B in bf16 at n = 80: 0.132 ms per 4-frame 360x640 call at
// 3.35 TB/s); its n * n multiply-adds a pixel (11.8 GFLOP there) take about
// 0.012 ms at the tensor cores' bf16 peak.  What holds it back from that
// bound is its instruction issue: per tile, the copies' addressing, the
// fragments' loads and scales and the epilogue (tools/bench_conv.py --only
// back: fewer instructions a tile made it faster, where three or four
// stages of loads in flight, or 256-pixel tiles, made it slower; PERF.md).
#include "conv_core.cuh"

namespace shiftnet {

constexpr int kBackPx = 128;  // pixels a tile
constexpr int kBackXp = core::cm_pitch(kBackPx);

// Elements of one stage: s and y tiles [n][kBackXp], then ca [n].
__host__ __device__ inline size_t naf_back_stage(int n) {
  return 2 * (size_t)n * kBackXp + n;
}

// Two stages, then the panel.
template <typename T>
__host__ __device__ inline size_t naf_back_smem(int n) {
  return (2 * naf_back_stage(n) + (size_t)n * core::mma_pitch<T>(n)) *
         sizeof(T);
}

template <typename T, int NTW, int WN>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    naf_back_mma_kernel(const T* y, const T* __restrict__ s,
                        const T* __restrict__ ca, const T* __restrict__ w7,
                        const float* __restrict__ beta,
                        const float* __restrict__ b7, T* out, int T_, int n,
                        long long plane, int tiles, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = kBackPx, xp = kBackXp;
  const int kp = core::mma_pitch<T>(n);
  const size_t stage = naf_back_stage(n);
  T* stages = reinterpret_cast<T*>(smem_raw);
  T* wbuf = stages + 2 * stage;
  const int jobs = T_ * tiles;

  // beta and b7 of the thread's epilogue channels, in registers
  float bs[NTW][2], bb[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = core::cm_channel<NTW, WN>(j) + e;
      bs[j][e] = beta[co];
      bb[j][e] = b7 ? b7[co] : 0.f;
    }
  // The job's s, y and ca into a stage: one commit group.
  auto load = [&](int job, T* dst) {
    const int t = job / tiles;
    const long long p0 = (long long)(job - t * tiles) * P;
    const size_t frame = (size_t)t * n * plane;
    core::load_planes(dst, xp, s + frame, n, plane, p0, P, aligned);
    core::load_planes(dst + (size_t)n * xp, xp, y + frame, n, plane, p0, P,
                      aligned);
    core::load_planes(dst + 2 * (size_t)n * xp, n, ca + (size_t)t * n, 1,
                      (long long)n, 0, n, aligned);
    core::commit_async();
  };
  core::load_async(wbuf, w7, n * kp);  // the panel, once
  if ((int)blockIdx.x < jobs) load(blockIdx.x, stages);
  int i = 0;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x, ++i) {
    T* cur = stages + (i & 1) * stage;
    const int next = job + gridDim.x;
    if (next < jobs)  // into the other stage, free since the last job's end
      load(next, stages + ((i + 1) & 1) * stage);
    else
      core::commit_async();
    core::wait_async_but_newest();  // this job's stage and the panel
    __syncthreads();
    T* ys = cur + (size_t)n * xp;
    core::cm_tile<T, NTW, WN, WN, true>(
        cur, xp, n, wbuf, kp, P, cur + 2 * (size_t)n * xp,
        [&](int p, int j, int co, float v0, float v1) {
          T* o = ys + (size_t)co * xp + p;
          o[0] = from_f<T>(to_f(o[0]) + (v0 + bb[j][0]) * bs[j][0]);
          o[xp] = from_f<T>(to_f(o[xp]) + (v1 + bb[j][1]) * bs[j][1]);
        });
    __syncthreads();
    const int t = job / tiles;
    core::store_planes(out + (size_t)t * n * plane, ys, xp, n, plane,
                       (long long)(job - t * tiles) * P, P, aligned);
    __syncthreads();  // the stage is free for the job after next
  }
  core::wait_async();
}

template <typename T>
static int launch_naf_back(const void* y, const void* s, const void* ca,
                           const void* w7, const void* beta, const void* b7,
                           void* out, int T_, int n, long long plane,
                           bool aligned, cudaStream_t stream) {
  if (n % 8) return (int)cudaErrorInvalidValue;
  const long long tiles = (plane + kBackPx - 1) / kBackPx;
  if ((long long)T_ * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = naf_back_smem<T>(n);
  return core::dispatch_np(n, [&](auto ntw, auto wn) {
    auto kern = naf_back_mma_kernel<T, decltype(ntw)::value,
                                    decltype(wn)::value>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int jobs = T_ * (int)tiles;
    const int blocks = core::persistent_grid(kern, smem, jobs, jobs);
    kern<<<blocks, core::kThreads, smem, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(s),
        static_cast<const T*>(ca), static_cast<const T*>(w7),
        static_cast<const float*>(beta), static_cast<const float*>(b7),
        static_cast<T*>(out), T_, n, plane, (int)tiles, aligned);
    return (int)cudaGetLastError();
  });
}

}  // namespace shiftnet

// y, s, out: (T, n, H, W), out may be y; ca: (T, n) in y's type; w7 the
// projection's panel [n][mma_pitch(n)] in y's type (output channels on the
// rows); beta float32 [n]; b7 float32 [n] or null.  n a multiple of 8, up
// to 112.  aligned: the planes, ca and every pointer on the 16-byte grid
// (16-byte copies), else element loads.
extern "C" int shiftnet_naf_back(int dtype, const void* y, const void* s,
                                 const void* ca, const void* w7,
                                 const void* beta, const void* b7, void* out,
                                 int T, int n, long long plane, int aligned,
                                 void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_naf_back<__nv_bfloat16>(y, s, ca, w7, beta, b7, out, T, n,
                                          plane, aligned != 0, st);
  if (dtype == kF32)
    return launch_naf_back<float>(y, s, ca, w7, beta, b7, out, T, n, plane,
                                  aligned != 0, st);
  return (int)cudaErrorInvalidValue;
}
