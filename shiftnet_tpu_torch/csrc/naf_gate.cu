// Kernel F, naf_gate: the front of a CAB2 / CAB1 gated block,
//
//   [CAB2: hw2 = dw3x3(hw, dwc)] -> LayerNorm over [y; hw2], folded into
//   the 1x1 expand to 2n -> RepConv2 (depthwise 3x3 + identity) ->
//   SimpleGate g = d[:n] * d[n:],
//
// plus float32 channel sums of g per frame, one partial sum per block
// (the denoise mid-CALayer reads them; conv_core.cuh, FrameSums).
// Replaces shiftnet_tpu/ops/naf_chw.py:_naf_gate_kernel (naf_cab_chw).
// Rounding follows the XLA twin naf_cab_chw_xla: hw2 and the expand output
// e are cast to the compute type before the depthwise convs read them; the
// RepConv2 sum and the gate product are float32 and g is cast once.
//
// The LayerNorm statistics are per pixel, so the folded form is exact:
//   w0 . LN(x) = inv * (wg . x) - inv * mu * c1 + c2,
//   wg = w0 * gamma, c1 = w0 . gamma, c2 = w0 . beta_ln   (ops/naf_chw.py,
// prep_naf), with mu = s1 / cin, var = s2 / cin - mu^2, inv = rsqrt(var +
// eps) over the cin = n + add_c channels in float32.
//
// Blocks are persistent: as many as the card holds at once, each loading
// the expand's panel once and walking over (frame, TH x TW output tile)
// jobs.  The expand region is the tile plus a 1-pixel halo (RepConv2's 3x3
// reads it).  Shared memory holds, in this order:
//   wbuf      the expand's panel [2n][mma_pitch(cin)] in the compute type
//             (ops/naf_chw.py, prep_naf: wg_p), resident;
//   xin       [expand region][mma_pitch(cin)], pixel-major: y staged in
//             columns 0 .. n-1, hw2 computed into n .. cin-1 (a chunk
//             boundary); later the g tile, channel-major, for the stores
//             and the sums;
//   ebuf      first hw staged with a 2-pixel halo, pixel-major (the dw3x3
//             of conv1 reads one pixel beyond the expand region), then e
//             [expand region][2n + 8];
//   mu, inv   float32 LN statistics of the expand region;
//   c1, c2    the folded LN's float32 terms, [2n] each.
// Every staged value outside the image is zero, and so are hw2 and e there:
// each reference conv zero-pads its own input, and LayerNorm of a zero
// pixel is c2 != 0, so e is masked in the expand's epilogue before
// RepConv2 reads it.
//
// What bounds it: arithmetic.  The expand is 2n * cin multiply-adds per
// pixel (19,200 at n = 80: 38.4 kFLOP) over the tile plus its halo; its
// bytes, 400 B per pixel in bf16 (y and hw read, g written), give 1.10 ms
// per 40-frame 360x640 CAB2 at 3.35 TB/s.  The expand runs on the tensor
// cores (conv_core.cuh's conv_tile as a one-tap conv: mma.sync in
// bfloat16, 3xTF32 in float32) over the pixel-major [y; hw2] tile, with
// the LayerNorm, the mask and the cast in its epilogue.  The depthwise
// convs (hw2: 9 add_c, RepConv2: 18 n multiply-adds a pixel), the LN sums
// and the gate stay on the CUDA cores, each thread on a channel pair so a
// warp's loads are contiguous.  The wrapper picks the tile (ops/naf_chw.py,
// naf_gate_tile; naf_gate_smem mirrors the sizes).
#include "conv_core.cuh"

namespace shiftnet {

constexpr int kGateSbufPad = 8;  // g tile: channel planes TH * TW + 8 apart
constexpr int kGatePx = 4;       // RepConv2: pixels of a row per item
// e's row: 2n channels and 8 more, so the 8 pixels of an epilogue's store
// fall in distinct banks.
__host__ __device__ inline int e_pitch(int n) { return 2 * n + 8; }

template <typename T>
__host__ __device__ inline size_t naf_gate_smem(int n, int add_c, int TH,
                                                int TW) {
  const size_t m1 = (size_t)(TH + 2) * (TW + 2);
  const size_t a2 = (size_t)(TH + 4) * (TW + 4);
  const size_t sx = core::mma_pitch<T>(n + add_c);
  const size_t gt = (size_t)n * (TH * TW + kGateSbufPad);
  const size_t xin = m1 * sx > gt ? m1 * sx : gt;
  const size_t hw = add_c ? a2 * core::mma_pitch<T>(add_c) : 0;
  const size_t e = m1 * e_pitch(n) > hw ? m1 * e_pitch(n) : hw;
  return (2 * n * sx + xin + e) * sizeof(T) +
         (2 * m1 + 4 * n) * sizeof(float);
}

template <typename T, int NTW>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    naf_gate_mma_kernel(const T* __restrict__ y, const T* __restrict__ hw,
                        const T* __restrict__ wg,
                        const float* __restrict__ c1,
                        const float* __restrict__ c2,
                        const float* __restrict__ dw0,
                        const float* __restrict__ dwc, T* __restrict__ g,
                        float* __restrict__ sums, int T_, int n, int add_c,
                        int H, int W, int TH, int TW, int tiles_x,
                        int n_tiles, int sum_rows, float eps) {
  constexpr int CH = core::chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int MH = TH + 2, MW = TW + 2, M1 = MH * MW;  // expand region
  const int HW2 = TW + 4;                            // hw, 2-pixel halo
  const int cin = n + add_c, n2 = 2 * n, se = e_pitch(n);
  const int sx = core::mma_pitch<T>(cin);
  const int hp = core::mma_pitch<T>(add_c);
  const int sbp = TH * TW + kGateSbufPad;
  const size_t x_elems = (size_t)M1 * sx, g_elems = (size_t)n * sbp;
  const size_t e_elems = (size_t)M1 * se;
  const size_t h_elems = add_c ? (size_t)(TH + 4) * HW2 * hp : 0;
  T* wbuf = reinterpret_cast<T*>(smem_raw);
  T* xin = wbuf + (size_t)n2 * sx;
  T* ebuf = xin + (x_elems > g_elems ? x_elems : g_elems);
  float* mu = reinterpret_cast<float*>(ebuf +
                                       (e_elems > h_elems ? e_elems : h_elems));
  float* inv = mu + M1;
  float* c1s = inv + M1;
  float* c2s = c1s + n2;
  T* e = ebuf;  // e over hw, once hw2 exists
  T* gt = xin;  // the g tile over [y; hw2], once e exists
  const size_t plane = (size_t)H * W;

  core::FrameSums<T> frame_sums(sums, sum_rows, n);
  SHIFTNET_PHASE_START;
  // The expand's panel, once: persistent blocks walk over the tiles.
  core::load_async(wbuf, wg, n2 * sx);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    c1s[i] = c1[i];
    c2s[i] = c2[i];
  }
  for (int job = blockIdx.x; job < T_ * n_tiles; job += gridDim.x) {
    const int t = job / n_tiles, tile = job - t * n_tiles;
    const int y0 = (tile / tiles_x) * TH;
    const int x0 = (tile % tiles_x) * TW;
    // The expand region inside the frame: no pixel to mask.
    const bool inner = y0 >= 1 && x0 >= 1 && y0 + TH < H && x0 + TW < W;
    auto in_image = [&](int p) {  // expand-region pixel p inside the frame
      if (inner) return true;
      const int gy = y0 - 1 + p / MW, gx = x0 - 1 + p % MW;
      return gy >= 0 && gy < H && gx >= 0 && gx < W;
    };
    __syncthreads();  // the last tile's g tile is stored and summed

    // 1. y with a 1-pixel halo into xin; hw with a 2-pixel halo into ebuf.
    core::stage_tile_batched<T, 4>(xin, sx, y + (size_t)t * n * plane, n, H,
                                   W, y0 - 1, x0 - 1, MH, MW);
    if (add_c) {
      core::stage_tile_batched<T, 4>(ebuf, hp,
                                     hw + (size_t)t * add_c * plane, add_c,
                                     H, W, y0 - 2, x0 - 2, TH + 4, HW2);
      __syncthreads();
      SHIFTNET_PHASE(0);  // staging
      // 2. hw2 = dw3x3(hw, dwc) in float32 on the expand region, cast into
      //    xin's columns n ..; zero outside the image.  Expand pixel (r, q)
      //    reads hw rows r .. r + 2.
      const core::PairSlots ps(add_c / 2);
      if (!ps.idle()) {
        const int c = 2 * ps.pair;
        float w0[9], w1[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          w0[k] = __ldg(dwc + c * 9 + k);
          w1[k] = __ldg(dwc + (c + 1) * 9 + k);
        }
        for (int p = ps.slot; p < M1; p += ps.slots) {
          const int r = p / MW, q = p - r * MW;
          float a0 = 0.f, a1 = 0.f;
          if (in_image(p)) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                float v0, v1;
                core::load2(ebuf + ((size_t)(r + ky) * HW2 + q + kx) * hp + c,
                            v0, v1);
                a0 = fmaf(w0[ky * 3 + kx], v0, a0);
                a1 = fmaf(w1[ky * 3 + kx], v1, a1);
              }
          }
          core::store2(xin + (size_t)p * sx + n + c, a0, a1);
        }
      }
    }
    __syncthreads();
    SHIFTNET_PHASE(1);  // hw2 (CAB1: staging)

    // 3. LayerNorm statistics per pixel over the cin channels, in float32,
    //    16 bytes of a pixel's row at a time.
    for (int p = threadIdx.x; p < M1; p += blockDim.x) {
      float s1 = 0.f, s2 = 0.f;
      const T* row = xin + (size_t)p * sx;
      for (int c = 0; c < cin; c += CH) {
        const uint4 pack = *reinterpret_cast<const uint4*>(row + c);
        const T* v = reinterpret_cast<const T*>(&pack);
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const float f = to_f(v[k]);
          s1 += f;
          s2 = fmaf(f, f, s2);
        }
      }
      const float m = s1 / cin;
      mu[p] = m;
      inv[p] = rsqrtf(s2 / cin - m * m + eps);
    }

    SHIFTNET_PHASE(2);  // LN statistics
    // 4. e = inv * (wg . x) - inv * mu * c1 + c2 on the expand region, zero
    //    outside the image, cast into ebuf (hw is dead: hw2 holds what
    //    RepConv2's input needs).  conv_tile synchronises first.
    core::conv_tile<T, NTW, 2, 2, false, true>(
        xin, sx, cin, wg, wbuf, 1, MW, n2, sx,
        M1, [](int p) { return p; },
        [&](int p, int co, float v0, float v1) {
          float e0 = 0.f, e1 = 0.f;
          if (in_image(p)) {
            const float a = inv[p], am = a * mu[p];
            e0 = a * v0 - am * c1s[co] + c2s[co];
            e1 = a * v1 - am * c1s[co + 1] + c2s[co + 1];
          }
          core::store2(e + (size_t)p * se + co, e0, e1);
        });
    __syncthreads();
    SHIFTNET_PHASE(3);  // expand and its epilogue

    // 5. RepConv2 d = e + dw3x3(e, dw0) in float32; 6. g = d[:n] * d[n:],
    //    cast, into the g tile over the dead xin (zero outside the image).
    //    Item: channel pair (o, o + 1) and its partners (o + n, o + n + 1),
    //    kGatePx pixels of a row.
    {
      const core::PairSlots ps(n / 2);
      if (!ps.idle()) {
        const int o = 2 * ps.pair;
        float w[4][9];  // channels o, o + 1, o + n, o + n + 1
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 9; ++k)
            w[j][k] = __ldg(dw0 + (o + (j & 1) + (j >> 1) * n) * 9 + k);
        const int tchunk = TW / kGatePx;
        for (int it = ps.slot; it < TH * tchunk; it += ps.slots) {
          const int r = it / tchunk, q0 = (it - r * tchunk) * kGatePx;
          float d[4][kGatePx], ctr[4][kGatePx];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int u = 0; u < kGatePx; ++u) d[j][u] = 0.f;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            float v[4][kGatePx + 2];
#pragma unroll
            for (int k = 0; k < kGatePx + 2; ++k) {
              const T* px = e + ((size_t)(r + ky) * MW + q0 + k) * se + o;
              core::load2(px, v[0][k], v[1][k]);
              core::load2(px + n, v[2][k], v[3][k]);
            }
            if (ky == 1)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int u = 0; u < kGatePx; ++u) ctr[j][u] = v[j][u + 1];
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int u = 0; u < kGatePx; ++u)
                  d[j][u] = fmaf(w[j][ky * 3 + kx], v[j][u + kx], d[j][u]);
          }
#pragma unroll
          for (int u = 0; u < kGatePx; ++u) {
            const int p = r * TW + q0 + u;
            const bool in = y0 + r < H && x0 + q0 + u < W;
            const float g0 = (d[0][u] + ctr[0][u]) * (d[2][u] + ctr[2][u]);
            const float g1 = (d[1][u] + ctr[1][u]) * (d[3][u] + ctr[3][u]);
            gt[o * sbp + p] = from_f<T>(in ? g0 : 0.f);
            gt[(o + 1) * sbp + p] = from_f<T>(in ? g1 : 0.f);
          }
        }
      }
    }
    __syncthreads();
    SHIFTNET_PHASE(4);  // RepConv2 and the gate
    core::store_tile(gt, sbp, g + (size_t)t * n * plane, n, H, W, y0, x0, TH,
                     TW);
    frame_sums.add(t, gt, sbp, TH * TW);
    SHIFTNET_PHASE(5);  // stores and sums
  }
  frame_sums.flush();
}

template <typename T>
static int launch_naf_gate(const void* y, const void* hw, const void* wg,
                           const void* c1, const void* c2, const void* dw0,
                           const void* dwc, void* g, void* sums, int T_, int n,
                           int add_c, int H, int W, int TH, int TW,
                           int sum_rows, float eps, cudaStream_t stream) {
  if (n % 16 || add_c % 8 || TW % 8 || TH < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = tiles_x * ((H + TH - 1) / TH);
  const size_t smem = naf_gate_smem<T>(n, add_c, TH, TW);
  return core::dispatch_np<true>(2 * n, [&](auto ntw, auto) {
    auto kern = naf_gate_mma_kernel<T, decltype(ntw)::value>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int blocks =
        core::persistent_grid(kern, smem, T_ * n_tiles, sum_rows);
    kern<<<blocks, core::kThreads, smem, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(hw),
        static_cast<const T*>(wg), static_cast<const float*>(c1),
        static_cast<const float*>(c2), static_cast<const float*>(dw0),
        static_cast<const float*>(dwc), static_cast<T*>(g),
        static_cast<float*>(sums), T_, n, add_c, H, W, TH, TW, tiles_x,
        n_tiles, sum_rows, eps);
    return (int)cudaGetLastError();
  });
}

}  // namespace shiftnet

// y: (T, n, H, W); hw: (T, add_c, H, W) or null with add_c = 0 (CAB1); wg:
// the expand's panel [2n][mma_pitch(n + add_c)] in y's type (ops/naf_chw.py,
// prep_naf: wg_p); c1, c2 float32 [2n]; dw0 float32 [2n][9]; dwc float32
// [add_c][9] or null; g: (T, n, H, W); sums float32 [T][sum_rows][n],
// zeroed: row (t, b) gets block b's sums over its tiles of frame t, and the
// grid has at most sum_rows blocks.  n must be 32, 48, 64 or 80, add_c a
// multiple of 8, TW of 8.
extern "C" int shiftnet_naf_gate(int dtype, const void* y, const void* hw,
                                 const void* wg, const void* c1,
                                 const void* c2, const void* dw0,
                                 const void* dwc, void* g, void* sums, int T,
                                 int n, int add_c, int H, int W, int TH,
                                 int TW, int sum_rows, float eps,
                                 void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_naf_gate<__nv_bfloat16>(y, hw, wg, c1, c2, dw0, dwc, g,
                                          sums, T, n, add_c, H, W, TH, TW,
                                          sum_rows, eps, st);
  if (dtype == kF32)
    return launch_naf_gate<float>(y, hw, wg, c1, c2, dw0, dwc, g, sums, T, n,
                                  add_c, H, W, TH, TW, sum_rows, eps, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef SHIFTNET_PHASES
// Per-phase cycles of naf_gate's blocks since the last call (phases 0-5:
// staging, hw2, LN statistics, expand, RepConv2 + gate, stores + sums).
extern "C" int shiftnet_naf_gate_phases(unsigned long long* out) {
  return shiftnet::core::read_phase_cycles(out);
}
#endif
