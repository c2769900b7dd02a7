// Kernel F, naf_gate: the front of a CAB2 / CAB1 gated block,
//
//   [CAB2: hw2 = dw3x3(hw, dwc)] -> LayerNorm over [y; hw2], folded into
//   the 1x1 expand to 2n -> RepConv2 (depthwise 3x3 + identity) ->
//   SimpleGate g = d[:n] * d[n:],
//
// plus per-block float32 channel sums of g (the denoise mid-CALayer reads
// them).  Replaces shiftnet_tpu/ops/naf_chw.py:_naf_gate_kernel
// (naf_cab_chw).  Rounding follows the XLA twin naf_cab_chw_xla: hw2 and the
// expand output e are cast to the compute type before the depthwise convs
// read them; the RepConv2 sum and the gate product are float32 and g is
// cast once.
//
// The LayerNorm statistics are per pixel, so the folded form is exact:
//   w0 . LN(x) = inv * (wg . x) - inv * mu * c1 + c2,
//   wg = w0 * gamma, c1 = w0 . gamma, c2 = w0 . beta_ln   (ops/naf_chw.py,
// prep_naf), with mu = s1 / cin, var = s2 / cin - mu^2, inv = rsqrt(var +
// eps) over the cin = n + add_c channels in float32.
//
// One block covers one frame and a TH x TW output tile.  Shared memory
// holds, in this order:
//   mu, inv   float32 LN statistics of the expand region (the tile plus a
//             1-pixel halo: the depthwise 3x3 of RepConv2 reads it);
//   xin       [cin][expand region]: y staged with its 1-pixel halo, then
//             hw2 computed on the same region;
//   big       first hw staged with a 2-pixel halo (the dw3x3 of conv1 reads
//             one pixel beyond the expand region), then, once hw2 exists,
//             e [2n][expand region].
// Every staged value outside the image is zero, and so are hw2 and e there:
// each reference conv zero-pads its own input, and LayerNorm of a zero
// pixel is c2 != 0, so e must be re-masked before RepConv2 reads it.
//
// Shared memory at n = 80 (CAB2: add_c = 40, cin = 120; CAB1: cin = 80),
// out of the 232,448 B a block may use: bf16 16 x 16 tiles take 184,048 B
// (CAB2) and 158,128 B (CAB1); float32 drops to 8 x 16 tiles, 203,072 B and
// 174,272 B (ops/naf_chw.py, naf_gate_tile).
//
// What bounds it: arithmetic.  The expand is 2n * cin multiply-adds per
// pixel (19,200 at n = 80: 38.4 kFLOP), on the CUDA cores, over the tile
// plus its halo (1.27x the tile at 16 x 16).  Its bytes, 400 B per pixel in
// bf16 (y and hw read, g written), give 1.10 ms per 40-frame 360x640 CAB2
// at 3.35 TB/s; the arithmetic is ~23x that at the CUDA cores' 67 TFLOP/s.
// The design keeps every intermediate (hw2, e, d) in shared memory or
// registers, and blocks the expand as cab_front blocks its convs: each
// thread owns 8 output channels of 4 pixels and loads 8 weights as two
// 16-byte loads per input channel.  Tensor-core (mma/wgmma) expands are
// later work.
#include "common.cuh"

namespace shiftnet {

constexpr int kGateCob = 8;  // expand output channels per thread
constexpr int kGatePx = 4;   // pixels per thread
constexpr int kGateThreads = 256;
constexpr int kGateSlack = 8;  // a thread's last 4-pixel chunk may overrun

template <typename T>
__global__ void naf_gate_kernel(const T* __restrict__ y,
                                const T* __restrict__ hw,
                                const float* __restrict__ wg,
                                const float* __restrict__ c1,
                                const float* __restrict__ c2,
                                const float* __restrict__ dw0,
                                const float* __restrict__ dwc,
                                T* __restrict__ g, float* __restrict__ sums,
                                int n, int add_c, int H, int W, int TH, int TW,
                                int tiles_x, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int MH = TH + 2, MW = TW + 2, A1 = MH * MW;  // expand region
  const int HW2 = TW + 4, A2 = (TH + 4) * HW2;       // hw with 2-pixel halo
  const int cin = n + add_c, n2 = 2 * n;
  float* mu = reinterpret_cast<float*>(smem_raw);
  float* inv = mu + A1;
  T* xin = reinterpret_cast<T*>(inv + A1);
  T* big = xin + (size_t)cin * A1 + kGateSlack;

  const int t = blockIdx.z;
  const int tile = blockIdx.x;
  const int n_blocks = gridDim.x;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const size_t plane = (size_t)H * W;

  // 1. y with a 1-pixel halo, hw with a 2-pixel halo; zero outside.
  const T* yt = y + (size_t)t * n * plane;
  for (int i = threadIdx.x; i < n * A1; i += blockDim.x) {
    const int c = i / A1, rq = i - c * A1;
    const int gy = y0 - 1 + rq / MW, gx = x0 - 1 + rq % MW;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = yt[c * plane + (size_t)gy * W + gx];
    xin[i] = v;
  }
  if (add_c) {
    const T* ht = hw + (size_t)t * add_c * plane;
    for (int i = threadIdx.x; i < add_c * A2; i += blockDim.x) {
      const int c = i / A2, rq = i - c * A2;
      const int gy = y0 - 2 + rq / HW2, gx = x0 - 2 + rq % HW2;
      T v = from_f<T>(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = ht[c * plane + (size_t)gy * W + gx];
      big[i] = v;
    }
    __syncthreads();
    // 2. hw2 = dw3x3(hw, dwc) in float32 on the expand region, cast; zero
    //    outside the image.  Expand position (r, q) reads hw rows r..r+2.
    for (int i = threadIdx.x; i < add_c * A1; i += blockDim.x) {
      const int c = i / A1, rq = i - c * A1;
      const int r = rq / MW, q = rq % MW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + q;
      float acc = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const T* hp = big + (size_t)c * A2 + r * HW2 + q;
        const float* wp = dwc + c * 9;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            acc = fmaf(wp[ky * 3 + kx], to_f(hp[ky * HW2 + kx]), acc);
      }
      xin[(size_t)(n + c) * A1 + rq] = from_f<T>(acc);
    }
  }
  __syncthreads();

  // 3. LayerNorm statistics per pixel over the cin channels, in float32.
  for (int p = threadIdx.x; p < A1; p += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < cin; ++c) {
      const float v = to_f(xin[(size_t)c * A1 + p]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    const float m = s1 / cin;
    mu[p] = m;
    inv[p] = rsqrtf(s2 / cin - m * m + eps);
  }
  __syncthreads();

  // 4. e = inv * (wg . x) - inv * mu * c1 + c2 on the expand region; zero
  //    outside the image; cast.  wg is float32 [cin][2n].
  T* e = big;  // hw is dead: hw2 holds what RepConv2's input needs
  {
    const int nchunk = (A1 + kGatePx - 1) / kGatePx;
    const int items = (n2 / kGateCob) * nchunk;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int grp = i / nchunk;
      const int p0 = (i - grp * nchunk) * kGatePx;
      float acc[kGateCob][kGatePx];
#pragma unroll
      for (int j = 0; j < kGateCob; ++j)
#pragma unroll
        for (int u = 0; u < kGatePx; ++u) acc[j][u] = 0.f;
      const T* xp = xin + p0;
      const float* wp = wg + grp * kGateCob;
      for (int ci = 0; ci < cin; ++ci) {
        float v[kGatePx];
#pragma unroll
        for (int u = 0; u < kGatePx; ++u) v[u] = to_f(xp[u]);
        const float4 wa = reinterpret_cast<const float4*>(wp)[0];
        const float4 wb = reinterpret_cast<const float4*>(wp)[1];
        const float w[kGateCob] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int j = 0; j < kGateCob; ++j)
#pragma unroll
          for (int u = 0; u < kGatePx; ++u)
            acc[j][u] = fmaf(w[j], v[u], acc[j][u]);
        xp += A1;
        wp += n2;
      }
#pragma unroll
      for (int u = 0; u < kGatePx; ++u) {
        const int p = p0 + u;
        if (p >= A1) break;
        const int gy = y0 - 1 + p / MW, gx = x0 - 1 + p % MW;
        const bool in_image = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float a = inv[p], am = a * mu[p];
#pragma unroll
        for (int j = 0; j < kGateCob; ++j) {
          const int o = grp * kGateCob + j;
          const float v = a * acc[j][u] - am * c1[o] + c2[o];
          e[(size_t)o * A1 + p] = in_image ? from_f<T>(v) : from_f<T>(0.f);
        }
      }
    }
  }
  __syncthreads();

  // 5. RepConv2 d = e + dw3x3(e, dw0) in float32; 6. g = d[:n] * d[n:],
  //    cast.  Each item: one channel pair (o, o + n), 4 adjacent pixels.
  //    The tile of g also goes to gt (over the dead staged inputs) for the
  //    sums, zero outside the image.
  T* gt = xin;
  T* gb = g + (size_t)t * n * plane;
  {
    const int tchunk = TW / kGatePx;
    const int items = n * TH * tchunk;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int o = i / (TH * tchunk);
      const int rem = i - o * TH * tchunk;
      const int r = rem / tchunk;
      const int q0 = (rem - r * tchunk) * kGatePx;
      const T* ea = e + (size_t)o * A1 + r * MW + q0;
      const T* eb = e + (size_t)(o + n) * A1 + r * MW + q0;
      const float* wa = dw0 + o * 9;
      const float* wb = dw0 + (o + n) * 9;
      float da[kGatePx], db[kGatePx];
#pragma unroll
      for (int u = 0; u < kGatePx; ++u) da[u] = db[u] = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float va[kGatePx + 2], vb[kGatePx + 2];
#pragma unroll
        for (int k = 0; k < kGatePx + 2; ++k) {
          va[k] = to_f(ea[ky * MW + k]);
          vb[k] = to_f(eb[ky * MW + k]);
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float fa = wa[ky * 3 + kx], fb = wb[ky * 3 + kx];
#pragma unroll
          for (int u = 0; u < kGatePx; ++u) {
            da[u] = fmaf(fa, va[u + kx], da[u]);
            db[u] = fmaf(fb, vb[u + kx], db[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGatePx; ++u) {
        const float a = da[u] + to_f(ea[MW + 1 + u]);
        const float b = db[u] + to_f(eb[MW + 1 + u]);
        const int gy = y0 + r, gx = x0 + q0 + u;
        const bool in_image = gy < H && gx < W;
        const T v = in_image ? from_f<T>(a * b) : from_f<T>(0.f);
        gt[(size_t)o * TH * TW + r * TW + q0 + u] = v;
        if (in_image) gb[o * plane + (size_t)gy * W + gx] = v;
      }
    }
  }
  __syncthreads();

  // Per-channel tile sums of g as stored, one warp per channel.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < n; c += nwarps) {
    float part = 0.f;
    for (int p = lane; p < TH * TW; p += 32)
      part += to_f(gt[(size_t)c * TH * TW + p]);
    part = warp_sum(part);
    if (lane == 0) sums[((size_t)t * n_blocks + tile) * n + c] = part;
  }
}

template <typename T>
static int launch_naf_gate(const void* y, const void* hw, const void* wg,
                           const void* c1, const void* c2, const void* dw0,
                           const void* dwc, void* g, void* sums, int T_, int n,
                           int add_c, int H, int W, int TH, int TW, float eps,
                           cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const size_t a1 = (size_t)(TH + 2) * (TW + 2);
  const size_t a2 = (size_t)(TH + 4) * (TW + 4);
  const size_t big = 2 * n * a1 > add_c * a2 ? 2 * n * a1 : add_c * a2;
  const size_t smem = 2 * a1 * sizeof(float) +
                      ((n + add_c) * a1 + kGateSlack + big) * sizeof(T);
  cudaFuncSetAttribute(naf_gate_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(tiles_x * tiles_y, 1, T_);
  naf_gate_kernel<T><<<grid, kGateThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(hw),
      static_cast<const float*>(wg), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<const float*>(dw0),
      static_cast<const float*>(dwc), static_cast<T*>(g),
      static_cast<float*>(sums), n, add_c, H, W, TH, TW, tiles_x, eps);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// y: (T, n, H, W); hw: (T, add_c, H, W) or null with add_c = 0 (CAB1);
// wg float32 [n + add_c][2n]; c1, c2 float32 [2n]; dw0 float32 [2n][9];
// dwc float32 [add_c][9] or null; g: (T, n, H, W); sums float32
// [T][n_blocks][n].  TW must be a multiple of 4.
extern "C" int shiftnet_naf_gate(int dtype, const void* y, const void* hw,
                                 const void* wg, const void* c1,
                                 const void* c2, const void* dw0,
                                 const void* dwc, void* g, void* sums, int T,
                                 int n, int add_c, int H, int W, int TH,
                                 int TW, float eps, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_naf_gate<__nv_bfloat16>(y, hw, wg, c1, c2, dw0, dwc, g,
                                          sums, T, n, add_c, H, W, TH, TW, eps,
                                          st);
  if (dtype == kF32)
    return launch_naf_gate<float>(y, hw, wg, c1, c2, dw0, dwc, g, sums, T, n,
                                  add_c, H, W, TH, TW, eps, st);
  return (int)cudaErrorInvalidValue;
}
