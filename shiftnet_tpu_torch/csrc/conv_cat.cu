// Kernel I, conv_cat: a 3x3 stride-1 convolution over the virtual channel
// concat of n_in in {2, 3} inputs of one shape, with optional float32 bias
// and optional PReLU applied in float32 before the single cast to the output
// type.
//
// Replaces shiftnet_tpu/ops/chw.py:_conv_cat_kernel (conv_concat_chw).  With
// GShiftNetConfig.conv_concat it runs rconcat (3 x Cin -> Cout) and
// Encoder2's conv_hr0 (2 x Cin -> Cout), Cin = Cout = 24 (14 in the small
// variants), at full resolution, so the 72- and 48-channel concats of those
// two convs are never allocated.
//
// What bounds it: arithmetic, 9 n_in Cin Cout multiply-adds per output
// pixel (115 GFLOP for a 4-frame 720p rconcat), against (n_in Cin + Cout)
// * itemsize bytes a pixel in and out (0.211 ms in bf16 at rconcat).
//
// It runs on the tensor cores (conv_core.cuh's implicit GEMM on mma.sync;
// bfloat16 products in bfloat16, 3xTF32 in float32), as conv.cu does over
// a concat that exists.  Here the concat exists only in shared memory, as
// the TPU kernel's exists only in VMEM: each input is staged into its own
// pad_chunk(Cin) columns of one pixel-major tile (the output tile and its
// 1-pixel halo, zero outside the image and in the padding channels), row
// pitch mma_pitch(n_in * pad_chunk(Cin)), and one conv_tile runs over all
// the columns with all output channels in one block.  The weights come
// packed [9][Np][KP] with each input's channels at its padded column offset
// (ops/chw.py, pack_cat_taps).  Blocks are persistent (as many as the card
// holds at once) and walk over the (frame, tile) jobs.  Panels that fit
// conv_core.cuh's resident size (every bfloat16 form, 31 KB at 3 x 24 ->
// 24) are loaded once a block; larger ones (float32 3 x 24 -> 24, 65 KB)
// stream one tap at a time, double-buffered, as conv.cu's do, so that two
// blocks still share an SM (kept whole, they allowed one).  A block stages
// a tile, then runs its products and epilogue (tools/phase_naf.py times
// the two phases).
#include "conv_core.cuh"

namespace shiftnet {

constexpr int kCatMaxIn = 3;

template <typename T>
struct CatInputs {
  const T* x[kCatMaxIn];
};

// Shared memory of one block: the panels (whole, or two streamed taps),
// then the tile with its halo.
template <typename T>
inline size_t conv_cat_smem(int Np, int KP, int TH, int TW) {
  return core::weight_smem<T>(9, Np, KP) +
         (size_t)(TH + 2) * (TW + 2) * KP * sizeof(T);
}

template <typename T, int NTW, int WN, bool kWhole>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    conv_cat_mma_kernel(CatInputs<T> in, int n_in,
                        const T* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ alpha, T* __restrict__ out,
                        int T_, int Cin, int Cout, int H, int W, int Np,
                        int KP, int TH, int TW, int tiles_x, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IW = TW + 2;
  const int cp = core::pad_chunk<T>(Cin);
  T* wbuf = reinterpret_cast<T*>(smem_raw);
  T* xin = wbuf + core::weight_smem<T>(9, Np, KP) / sizeof(T);
  const size_t plane = (size_t)H * W;
  const float a = alpha ? alpha[0] : 0.f;

  // Whole panels: once, waited for in conv_tile.
  if constexpr (kWhole) core::load_async(wbuf, w, 9 * Np * KP);
  SHIFTNET_PHASE_START;
  for (int job = blockIdx.x; job < T_ * n_tiles; job += gridDim.x) {
    const int t = job / n_tiles, tile = job - t * n_tiles;
    const int oy0 = (tile / tiles_x) * TH;
    const int ox0 = (tile % tiles_x) * TW;
    __syncthreads();  // every warp is done with the last tile
    for (int s = 0; s < n_in; ++s)
      core::stage_tile_batched<T, 4>(xin + s * cp, KP,
                                     in.x[s] + (size_t)t * Cin * plane, Cin,
                                     H, W, oy0 - 1, ox0 - 1, TH + 2, IW);
    SHIFTNET_PHASE(0);  // staging
    T* ot = out + (size_t)t * Cout * plane;
    core::conv_tile<T, NTW, WN, 2, false, kWhole>(
        xin, KP, n_in * cp, w, wbuf, 3, IW, Np, KP, TH * TW,
        [&](int p) { return (p / TW) * IW + p % TW; },
        [&](int p, int co, float v0, float v1) {
          const int r = p / TW;
          const int oy = oy0 + r, ox = ox0 + p - r * TW;
          if (oy >= H || ox >= W) return;
          const float v[2] = {v0, v1};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (co + u >= Cout) break;
            float y = v[u];
            if (bias) y += bias[co + u];
            if (alpha) y = prelu(y, a);
            ot[(co + u) * plane + (size_t)oy * W + ox] = from_f<T>(y);
          }
        });
    SHIFTNET_PHASE(1);  // products and epilogue
  }
}

template <typename T>
static int launch_conv_cat(const void* x0, const void* x1, const void* x2,
                           int n_in, const void* w, const void* bias,
                           const void* alpha, void* out, int T_, int Cin,
                           int Cout, int H, int W, int Np, int KP, int TH,
                           int TW, cudaStream_t stream) {
  if (n_in < 2 || n_in > kCatMaxIn || Np < core::pad_chunk<T>(Cout) ||
      KP != core::mma_pitch<T>(n_in * core::pad_chunk<T>(Cin)))
    return (int)cudaErrorInvalidValue;
  CatInputs<T> in{{static_cast<const T*>(x0), static_cast<const T*>(x1),
                   static_cast<const T*>(x2)}};
  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = tiles_x * ((H + TH - 1) / TH);
  const size_t smem = conv_cat_smem<T>(Np, KP, TH, TW);
  const bool whole = core::resident<T>(9, Np, KP);
  return core::dispatch_np(Np, [&](auto ntw, auto wn) {
    constexpr int NTW = decltype(ntw)::value, WN = decltype(wn)::value;
    auto kern = whole ? &conv_cat_mma_kernel<T, NTW, WN, true>
                      : &conv_cat_mma_kernel<T, NTW, WN, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int jobs = T_ * n_tiles;
    const int grid = core::persistent_grid(kern, smem, jobs, jobs);
    kern<<<grid, core::kThreads, smem, stream>>>(
        in, n_in, static_cast<const T*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(alpha), static_cast<T*>(out), T_, Cin,
        Cout, H, W, Np, KP, TH, TW, tiles_x, n_tiles);
    return (int)cudaGetLastError();
  });
}

}  // namespace shiftnet

// x2 is null when n_in = 2.  w packed [9][Np][KP] in the inputs' type
// (ops/chw.py, pack_cat_taps), KP = mma_pitch(n_in * pad_chunk(Cin)),
// output tile TH x TW.  bias and alpha are float32 device pointers, or null
// when absent.
extern "C" int shiftnet_conv_cat(int dtype, const void* x0, const void* x1,
                                 const void* x2, int n_in, const void* w,
                                 const void* bias, const void* alpha,
                                 void* out, int T, int Cin, int Cout, int H,
                                 int W, int Np, int KP, int TH, int TW,
                                 void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_conv_cat<__nv_bfloat16>(x0, x1, x2, n_in, w, bias, alpha,
                                          out, T, Cin, Cout, H, W, Np, KP,
                                          TH, TW, st);
  if (dtype == kF32)
    return launch_conv_cat<float>(x0, x1, x2, n_in, w, bias, alpha, out, T,
                                  Cin, Cout, H, W, Np, KP, TH, TW, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef SHIFTNET_PHASES
// Per-phase cycles of conv_cat's blocks since the last call (phases 0-1:
// staging, products + epilogue).
extern "C" int shiftnet_conv_cat_phases(unsigned long long* out) {
  return shiftnet::core::read_phase_cycles(out);
}
#endif
