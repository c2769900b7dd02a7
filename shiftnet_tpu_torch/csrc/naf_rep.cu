// Kernel G, naf_rep: the middle of a CAB2 / CAB1 gated block,
//
//   [g * cag (denoise mid-CALayer scale)] -> RepConv (5x5 + 3x3 + identity,
//   merged into one 5x5, grouped or depthwise) -> 1x1 expand n -> 2n ->
//   SimpleGate2 s = e2[:n] * sigmoid(e2[n:]),
//
// plus per-block float32 channel sums of s (CALayer2 reads them).
// Replaces shiftnet_tpu/ops/naf_chw.py:_naf_rep_kernel (naf_cab_chw).
// Rounding follows the XLA twin naf_cab_chw_xla: g * cag is a product in
// the compute type, the RepConv output r is cast before the expand, and the
// two SimpleGate2 factors are cast separately before their product.
//
// The RepConv comes in the two forms the models use, a template parameter
// G (input channels per group):
// - G = 8 (the big variants): output channel o reads the 8 input channels
//   8 * (o / 8) .. + 7; weight laid out [n/8][8 in][25 taps][8 out];
// - G = 1 (the small variants, depthwise): o reads channel o alone;
//   weight laid out [n][25 taps].
// Neither is densified.  The TPU kernel turned both into a block-diagonal
// (n, 25 n) matrix for its matrix unit, which costs n / G times the
// multiply-adds (10x at n = 80 grouped, 64x at n = 64 depthwise); on the
// CUDA cores the grouped and depthwise forms are the cheaper ones.  The
// host merges the branches in float32 and casts once (ops/naf_chw.py,
// prep_naf).
//
// One block covers one frame and a TH x TW tile.  Shared memory holds g
// with a 2-pixel halo (zero outside the image: the reference conv
// zero-pads its input) and r for the tile; the s tile for the sums reuses
// g's buffer.  n * ((TH+4)(TW+4) + TH TW) elements: at n = 80 and 16 x 16,
// 104,960 B in bf16 and 209,920 B in float32.
//
// What bounds it: its bytes, g read and s written, 4n B per pixel in bf16
// (320 B at n = 80, 0.88 ms per 40-frame 360x640 call at 3.35 TB/s; 256 B
// at n = 64).  Its arithmetic, 25 G n + 2n n multiply-adds per pixel
// (28,800 at n = 80 grouped, 9,792 at n = 64 depthwise), runs on the CUDA
// cores, so in practice the expand's float32 FMAs bound it.  For the 5x5
// each thread owns 8 output channels of 4 pixels (G = 8: one group, the 8
// channels share their inputs, 16-byte weight loads) or 1 channel of 4
// pixels (G = 1); for the expand, 8 + 8 channels (o and its gate partner
// o + n) of 4 pixels, with 16-byte weight loads.
#include "common.cuh"

namespace shiftnet {

constexpr int kRepCob = 8;
constexpr int kRepPx = 4;
constexpr int kRepThreads = 256;

template <typename T, int G>
__global__ void naf_rep_kernel(const T* __restrict__ g,
                               const T* __restrict__ cag,
                               const float* __restrict__ rep,
                               const float* __restrict__ w4,
                               T* __restrict__ s, float* __restrict__ sums,
                               int n, int H, int W, int TH, int TW,
                               int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IW = TW + 4, A2 = (TH + 4) * IW, TT = TH * TW;
  T* gs = reinterpret_cast<T*>(smem_raw);  // [n][A2]
  T* rs = gs + (size_t)n * A2;             // [n][TT]

  const int t = blockIdx.z;
  const int tile = blockIdx.x;
  const int n_blocks = gridDim.x;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const size_t plane = (size_t)H * W;
  const T* gt = g + (size_t)t * n * plane;

  for (int i = threadIdx.x; i < n * A2; i += blockDim.x) {
    const int c = i / A2, rq = i - c * A2;
    const int gy = y0 - 2 + rq / IW, gx = x0 - 2 + rq % IW;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = gt[c * plane + (size_t)gy * W + gx];
      if (cag) v = from_f<T>(to_f(v) * to_f(cag[(size_t)t * n + c]));
    }
    gs[i] = v;
  }
  __syncthreads();

  // Merged 5x5, grouped: item = one group of 8 output channels, 4 pixels.
  const int tchunk = TW / kRepPx;
  if constexpr (G == 8) {
    const int items = (n / kRepCob) * TH * tchunk;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int grp = i / (TH * tchunk);
      const int rem = i - grp * TH * tchunk;
      const int r = rem / tchunk;
      const int q0 = (rem - r * tchunk) * kRepPx;
      float acc[kRepCob][kRepPx];
#pragma unroll
      for (int j = 0; j < kRepCob; ++j)
#pragma unroll
        for (int u = 0; u < kRepPx; ++u) acc[j][u] = 0.f;
      const float* wp = rep + (size_t)grp * 8 * 25 * kRepCob;
      for (int ci = 0; ci < 8; ++ci) {
        const T* sp = gs + (size_t)(grp * 8 + ci) * A2 + r * IW + q0;
#pragma unroll
        for (int ky = 0; ky < 5; ++ky) {
          float v[kRepPx + 4];
#pragma unroll
          for (int k = 0; k < kRepPx + 4; ++k) v[k] = to_f(sp[ky * IW + k]);
#pragma unroll
          for (int kx = 0; kx < 5; ++kx) {
            const float4* w4p = reinterpret_cast<const float4*>(
                wp + ((ci * 25) + ky * 5 + kx) * kRepCob);
            const float4 wa = w4p[0], wb = w4p[1];
            const float w[kRepCob] = {wa.x, wa.y, wa.z, wa.w,
                                      wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < kRepCob; ++j)
#pragma unroll
              for (int u = 0; u < kRepPx; ++u)
                acc[j][u] = fmaf(w[j], v[u + kx], acc[j][u]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRepCob; ++j)
#pragma unroll
        for (int u = 0; u < kRepPx; ++u)
          rs[(size_t)(grp * kRepCob + j) * TT + r * TW + q0 + u] =
              from_f<T>(acc[j][u]);
    }
  } else {
    // Depthwise: item = one channel, 4 pixels of a row.
    static_assert(G == 1, "naf_rep: groups of 8 or depthwise");
    const int items = n * TH * tchunk;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int c = i / (TH * tchunk);
      const int rem = i - c * TH * tchunk;
      const int r = rem / tchunk;
      const int q0 = (rem - r * tchunk) * kRepPx;
      float acc[kRepPx];
#pragma unroll
      for (int u = 0; u < kRepPx; ++u) acc[u] = 0.f;
      const float* wp = rep + (size_t)c * 25;
      const T* sp = gs + (size_t)c * A2 + r * IW + q0;
#pragma unroll
      for (int ky = 0; ky < 5; ++ky) {
        float v[kRepPx + 4];
#pragma unroll
        for (int k = 0; k < kRepPx + 4; ++k) v[k] = to_f(sp[ky * IW + k]);
#pragma unroll
        for (int kx = 0; kx < 5; ++kx) {
          const float w = __ldg(wp + ky * 5 + kx);
#pragma unroll
          for (int u = 0; u < kRepPx; ++u)
            acc[u] = fmaf(w, v[u + kx], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRepPx; ++u)
        rs[(size_t)c * TT + r * TW + q0 + u] = from_f<T>(acc[u]);
    }
  }
  __syncthreads();

  // Expand n -> 2n and SimpleGate2: item = channels o..o+7 and their
  // partners o+n..o+n+7, 4 pixels.  w4 is float32 [n][2n].
  T* sbuf = gs;  // g is dead
  T* sb = s + (size_t)t * n * plane;
  {
    const int items = (n / kRepCob) * (TT / kRepPx);
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int grp = i / (TT / kRepPx);
      const int p0 = (i - grp * (TT / kRepPx)) * kRepPx;
      float acc[2 * kRepCob][kRepPx];
#pragma unroll
      for (int j = 0; j < 2 * kRepCob; ++j)
#pragma unroll
        for (int u = 0; u < kRepPx; ++u) acc[j][u] = 0.f;
      const T* rp = rs + p0;
      const float* wp = w4 + grp * kRepCob;
      for (int ci = 0; ci < n; ++ci) {
        float v[kRepPx];
#pragma unroll
        for (int u = 0; u < kRepPx; ++u) v[u] = to_f(rp[u]);
        const float4* wa = reinterpret_cast<const float4*>(wp);
        const float4* wb = reinterpret_cast<const float4*>(wp + n);
        const float4 a0 = wa[0], a1 = wa[1], b0 = wb[0], b1 = wb[1];
        const float w[2 * kRepCob] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                                      a1.z, a1.w, b0.x, b0.y, b0.z, b0.w,
                                      b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 2 * kRepCob; ++j)
#pragma unroll
          for (int u = 0; u < kRepPx; ++u)
            acc[j][u] = fmaf(w[j], v[u], acc[j][u]);
        rp += TT;
        wp += 2 * n;
      }
#pragma unroll
      for (int u = 0; u < kRepPx; ++u) {
        const int p = p0 + u;
        const int gy = y0 + p / TW, gx = x0 + p % TW;
        const bool in_image = gy < H && gx < W;
#pragma unroll
        for (int j = 0; j < kRepCob; ++j) {
          const int o = grp * kRepCob + j;
          const float a = to_f(from_f<T>(acc[j][u]));
          const float b =
              to_f(from_f<T>(1.f / (1.f + expf(-acc[kRepCob + j][u]))));
          const T v = in_image ? from_f<T>(a * b) : from_f<T>(0.f);
          sbuf[(size_t)o * TT + p] = v;
          if (in_image) sb[o * plane + (size_t)gy * W + gx] = v;
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < n; c += nwarps) {
    float part = 0.f;
    for (int p = lane; p < TT; p += 32) part += to_f(sbuf[(size_t)c * TT + p]);
    part = warp_sum(part);
    if (lane == 0) sums[((size_t)t * n_blocks + tile) * n + c] = part;
  }
}

template <typename T, int G>
static int launch_naf_rep(const void* g, const void* cag, const void* rep,
                          const void* w4, void* s, void* sums, int T_, int n,
                          int H, int W, int TH, int TW, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const size_t smem =
      (size_t)n * ((TH + 4) * (TW + 4) + TH * TW) * sizeof(T);
  cudaFuncSetAttribute(naf_rep_kernel<T, G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(tiles_x * tiles_y, 1, T_);
  naf_rep_kernel<T, G><<<grid, kRepThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(cag),
      static_cast<const float*>(rep), static_cast<const float*>(w4),
      static_cast<T*>(s), static_cast<float*>(sums), n, H, W, TH, TW,
      tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_naf_rep_group(int group, const void* g, const void* cag,
                                const void* rep, const void* w4, void* s,
                                void* sums, int T_, int n, int H, int W,
                                int TH, int TW, cudaStream_t stream) {
  if (group == 8)
    return launch_naf_rep<T, 8>(g, cag, rep, w4, s, sums, T_, n, H, W, TH, TW,
                                stream);
  if (group == 1)
    return launch_naf_rep<T, 1>(g, cag, rep, w4, s, sums, T_, n, H, W, TH, TW,
                                stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace shiftnet

// g, s: (T, n, H, W); cag: (T, n) in g's type, or null; group: input
// channels per RepConv group, 8 (rep float32 [n/8][8][25][8]) or 1
// (depthwise, rep float32 [n][25]); w4 float32 [n][2n]; sums float32
// [T][n_blocks][n].  n must be a multiple of 8, TW of 4.
extern "C" int shiftnet_naf_rep(int dtype, const void* g, const void* cag,
                                const void* rep, const void* w4, void* s,
                                void* sums, int T, int n, int group, int H,
                                int W, int TH, int TW, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_naf_rep_group<__nv_bfloat16>(group, g, cag, rep, w4, s, sums,
                                               T, n, H, W, TH, TW, st);
  if (dtype == kF32)
    return launch_naf_rep_group<float>(group, g, cag, rep, w4, s, sums, T, n,
                                       H, W, TH, TW, st);
  return (int)cudaErrorInvalidValue;
}
