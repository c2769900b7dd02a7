// Kernel G, naf_rep: the middle of a CAB2 / CAB1 gated block,
//
//   [g * cag (denoise mid-CALayer scale)] -> RepConv (5x5 + 3x3 + identity,
//   merged into one 5x5, grouped or depthwise) -> 1x1 expand n -> 2n ->
//   SimpleGate2 s = e2[:n] * sigmoid(e2[n:]),
//
// plus float32 channel sums of s per frame, one partial sum per block
// (CALayer2 reads them; conv_core.cuh, FrameSums).
// Replaces shiftnet_tpu/ops/naf_chw.py:_naf_rep_kernel (naf_cab_chw).
// Rounding follows the XLA twin naf_cab_chw_xla: g * cag is a product in
// the compute type, the RepConv output r is cast before the expand, and the
// two SimpleGate2 factors are cast separately before their product.
//
// The RepConv comes in the two forms the models use, a template parameter
// G (input channels per group):
// - G = 8 (the big variants): output channel o reads the 8 input channels
//   8 * (o / 8) .. + 7.  On the tensor cores (conv_core.cuh, group_tile):
//   a group's 8 channels are one K step (one 16-byte chunk in bfloat16, a
//   TF32 k8 in float32) and one n8 tile, a tap a row address; the panels
//   come packed [n/8][25][8][mma_pitch(8)] in the compute type
//   (ops/naf_chw.py, pack_groups).
// - G = 1 (the small variants, depthwise): o reads channel o alone, 25
//   multiply-adds a pixel and channel, on the CUDA cores; weight float32
//   [n][25].
// Neither is densified.  The TPU kernel turned both into a block-diagonal
// (n, 25 n) matrix for its matrix unit, which costs n / G times the
// multiply-adds.  The host merges the branches in float32 and casts once
// (ops/naf_chw.py, prep_naf).
//
// The expand runs on conv_core.cuh's conv_tile as a one-tap conv (mma.sync;
// 3xTF32 in float32) over r.  Its panel [2n][mma_pitch(n)] is packed with
// the gate interleave (ops/naf_chw.py, gate_rows): each n8 tile of channels
// o .. o + 7 is followed by the tile of their partners o + n .. o + n + 7,
// both in one warp, so the epilogue takes e2[o] and e2[o + n] from
// registers and e2 never goes to shared memory.
//
// Blocks are persistent: as many as the card holds at once, each loading
// the panels once and walking over (frame, TH x TW tile) jobs.  Shared
// memory holds, pixel-major at mma_pitch(n): g with a 2-pixel halo (zero
// outside the image: the reference conv zero-pads its input), then over it
// the s tile channel-major for the stores and the sums; r for the tile;
// then the weight panels (all groups' 5x5, the expand's).  The wrapper
// picks the tile (ops/naf_chw.py, naf_rep_tile; naf_rep_smem mirrors the
// sizes).
//
// What bounds it: its bytes, g read and s written, 4n B per pixel in bf16
// (320 B at n = 80, 0.88 ms per 40-frame 360x640 call at 3.35 TB/s).  Its
// arithmetic, 25 G n + 2n n multiply-adds per pixel (28,800 at n = 80
// grouped, 9,792 at n = 64 depthwise), is on the tensor cores but for the
// depthwise 5x5.
#include "conv_core.cuh"

namespace shiftnet {

constexpr int kRepSbufPad = 8;  // s tile: channel planes TH * TW + 8 apart
constexpr int kRepPx = 4;       // depthwise: pixels of a row per item

template <typename T>
__host__ __device__ inline size_t naf_rep_smem(int n, int G, int TH, int TW) {
  const size_t sp = core::mma_pitch<T>(n), tt = (size_t)TH * TW;
  const size_t in = (size_t)(TH + 4) * (TW + 4) * sp;
  const size_t sbuf = (size_t)n * (tt + kRepSbufPad);
  const size_t w_exp = (size_t)2 * n * sp;
  const size_t w_grp =
      G == 8 ? (size_t)(n / 8) * 25 * 8 * core::mma_pitch<T>(8) : 0;
  return ((in > sbuf ? in : sbuf) + tt * sp + w_grp + w_exp) * sizeof(T);
}

// One SimpleGate2 output: both factors cast to T before their product.
template <typename T>
__device__ __forceinline__ T gate2(float a, float b) {
  const float fa = to_f(from_f<T>(a));
  const float fb = to_f(from_f<T>(__frcp_rn(1.f + expf(-b))));
  return from_f<T>(fa * fb);
}

template <typename T, int G, int NTW>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    naf_rep_mma_kernel(const T* __restrict__ g, const T* __restrict__ cag,
                       const void* __restrict__ rep,
                       const T* __restrict__ w4, T* __restrict__ s,
                       float* __restrict__ sums, int T_, int n, int H, int W,
                       int TH, int TW, int tiles_x, int n_tiles,
                       int sum_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IH = TH + 4, IW = TW + 4, TT = TH * TW;
  const int sp = core::mma_pitch<T>(n);
  const int sbp = TT + kRepSbufPad;
  const size_t in_elems = (size_t)IH * IW * sp;
  const size_t s_elems = (size_t)n * sbp;
  const size_t grp_elems =
      G == 8 ? (size_t)(n / 8) * 25 * 8 * core::mma_pitch<T>(8) : 0;
  T* gs = reinterpret_cast<T*>(smem_raw);  // g, then the s tile
  T* rs = gs + (in_elems > s_elems ? in_elems : s_elems);
  T* wgrp = rs + (size_t)TT * sp;  // the 5x5's panels (G = 8)
  T* wexp = wgrp + grp_elems;      // the expand's
  T* sbuf = gs;
  const size_t plane = (size_t)H * W;

  core::FrameSums<T> frame_sums(sums, sum_rows, n);
  SHIFTNET_PHASE_START;
  // The panels, once: persistent blocks walk over the tiles.
  if constexpr (G == 8)
    core::load_async(wgrp, static_cast<const T*>(rep), (int)grp_elems);
  core::load_async(wexp, w4, 2 * n * sp);
  for (int job = blockIdx.x; job < T_ * n_tiles; job += gridDim.x) {
    const int t = job / n_tiles, tile = job - t * n_tiles;
    const int y0 = (tile / tiles_x) * TH;
    const int x0 = (tile % tiles_x) * TW;
    const bool inner = y0 + TH <= H && x0 + TW <= W;  // no pixel to mask
    __syncthreads();  // the last tile's s tile is stored and summed
    core::stage_tile_batched<T, 4>(gs, sp, g + (size_t)t * n * plane, n, H,
                                   W, y0 - 2, x0 - 2, IH, IW,
                                   cag ? cag + (size_t)t * n : nullptr);

    SHIFTNET_PHASE(0);  // staging
    // The merged 5x5 into r (pixel-major, cast).  Output pixel p reads rows
    // from its top-left tap (r, q) of the staged tile.
    auto r_store = [&](int p, int co, float v0, float v1) {
      core::store2(rs + (size_t)p * sp + co, v0, v1);
    };
    if constexpr (G == 8) {
      core::group_tile<T, 2, true>(
          gs, sp, n / 8, static_cast<const T*>(rep), wgrp, 5, IW, TT,
          [&](int p) { return (p / TW) * IW + p % TW; }, r_store);
    } else {
      static_assert(G == 1, "naf_rep: groups of 8 or depthwise");
      // A thread keeps one channel pair and its 50 weights; an item is
      // kRepPx pixels of a row.
      __syncthreads();
      const core::PairSlots ps(n / 2);
      if (!ps.idle()) {
        const int c = 2 * ps.pair;
        const float* wr = static_cast<const float*>(rep);
        float w0[25], w1[25];
#pragma unroll
        for (int k = 0; k < 25; ++k) {
          w0[k] = __ldg(wr + c * 25 + k);
          w1[k] = __ldg(wr + (c + 1) * 25 + k);
        }
        const int tchunk = TW / kRepPx;
        for (int it = ps.slot; it < TH * tchunk; it += ps.slots) {
          const int r = it / tchunk, q0 = (it - r * tchunk) * kRepPx;
          float a0[kRepPx], a1[kRepPx];
#pragma unroll
          for (int u = 0; u < kRepPx; ++u) a0[u] = a1[u] = 0.f;
#pragma unroll
          for (int ky = 0; ky < 5; ++ky) {
            const T* row = gs + ((size_t)(r + ky) * IW + q0) * sp + c;
            float v0[kRepPx + 4], v1[kRepPx + 4];
#pragma unroll
            for (int k = 0; k < kRepPx + 4; ++k)
              core::load2(row + (size_t)k * sp, v0[k], v1[k]);
#pragma unroll
            for (int kx = 0; kx < 5; ++kx)
#pragma unroll
              for (int u = 0; u < kRepPx; ++u) {
                a0[u] = fmaf(w0[ky * 5 + kx], v0[u + kx], a0[u]);
                a1[u] = fmaf(w1[ky * 5 + kx], v1[u + kx], a1[u]);
              }
          }
#pragma unroll
          for (int u = 0; u < kRepPx; ++u)
            r_store(r * TW + q0 + u, c, a0[u], a1[u]);
        }
      }
    }

    SHIFTNET_PHASE(1);  // the 5x5
    // Expand n -> 2n and SimpleGate2 into the s tile (zero outside the
    // image), over the dead g.
    core::conv_tile<T, NTW, 2, 1, true, true>(
        rs, sp, n, w4, wexp, 1, TW, 2 * n, sp, TT,
        [](int p) { return p; },
        [&](int p, int o, float a0, float a1, float b0, float b1) {
          const bool in = inner || (y0 + p / TW < H && x0 + p % TW < W);
          sbuf[o * sbp + p] = in ? gate2<T>(a0, b0) : from_f<T>(0.f);
          sbuf[(o + 1) * sbp + p] = in ? gate2<T>(a1, b1) : from_f<T>(0.f);
        });
    __syncthreads();
    SHIFTNET_PHASE(2);  // expand and SimpleGate2
    core::store_tile(sbuf, sbp, s + (size_t)t * n * plane, n, H, W, y0, x0,
                     TH, TW);
    frame_sums.add(t, sbuf, sbp, TT);
    SHIFTNET_PHASE(3);  // stores and sums
  }
  frame_sums.flush();
}

template <typename T, int G>
static int launch_naf_rep(const void* g, const void* cag, const void* rep,
                          const void* w4, void* s, void* sums, int T_, int n,
                          int H, int W, int TH, int TW, int sum_rows,
                          cudaStream_t stream) {
  if (n % 16 || TW % 8 || TH < 1) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = tiles_x * ((H + TH - 1) / TH);
  const size_t smem = naf_rep_smem<T>(n, G, TH, TW);
  return core::dispatch_np<true>(2 * n, [&](auto ntw, auto) {
    auto kern = naf_rep_mma_kernel<T, G, decltype(ntw)::value>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int blocks =
        core::persistent_grid(kern, smem, T_ * n_tiles, sum_rows);
    kern<<<blocks, core::kThreads, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(cag), rep,
        static_cast<const T*>(w4), static_cast<T*>(s),
        static_cast<float*>(sums), T_, n, H, W, TH, TW, tiles_x, n_tiles,
        sum_rows);
    return (int)cudaGetLastError();
  });
}

template <typename T>
static int launch_naf_rep_group(int group, const void* g, const void* cag,
                                const void* rep, const void* w4, void* s,
                                void* sums, int T_, int n, int H, int W,
                                int TH, int TW, int sum_rows,
                                cudaStream_t stream) {
  if (group == 8)
    return launch_naf_rep<T, 8>(g, cag, rep, w4, s, sums, T_, n, H, W, TH, TW,
                                sum_rows, stream);
  if (group == 1)
    return launch_naf_rep<T, 1>(g, cag, rep, w4, s, sums, T_, n, H, W, TH, TW,
                                sum_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace shiftnet

// g, s: (T, n, H, W); cag: (T, n) in g's type, or null; group: input
// channels per RepConv group, 8 (rep packed [n/8][25][8][mma_pitch(8)] in
// g's type) or 1 (depthwise, rep float32 [n][25]); w4 the expand packed
// [2n][mma_pitch(n)] in g's type with the gate interleave; sums float32
// [T][sum_rows][n], zeroed, as naf_gate's.  n must be 32, 48, 64 or 80, TW
// a multiple of 8.
extern "C" int shiftnet_naf_rep(int dtype, const void* g, const void* cag,
                                const void* rep, const void* w4, void* s,
                                void* sums, int T, int n, int group, int H,
                                int W, int TH, int TW, int sum_rows,
                                void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_naf_rep_group<__nv_bfloat16>(group, g, cag, rep, w4, s, sums,
                                               T, n, H, W, TH, TW, sum_rows,
                                               st);
  if (dtype == kF32)
    return launch_naf_rep_group<float>(group, g, cag, rep, w4, s, sums, T, n,
                                       H, W, TH, TW, sum_rows, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef SHIFTNET_PHASES
// Per-phase cycles of naf_rep's blocks since the last call (phases 0-3:
// staging, the 5x5, expand + SimpleGate2, stores + sums).
extern "C" int shiftnet_naf_rep_phases(unsigned long long* out) {
  return shiftnet::core::read_phase_cycles(out);
}
#endif
