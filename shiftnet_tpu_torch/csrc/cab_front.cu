// Kernel A, cab_front: the plain CAB body conv3x3 -> PReLU -> conv3x3
// (bias-free) plus per-block channel sums of its output.
//
// Replaces shiftnet_tpu/ops/chw.py:_cab_front_kernel (flat layout) and
// chw.py:_cab_front_s2d_kernel (phase-packed layouts): both compute the
// same function, and the packing existed only for the TPU's layout rules.
//
// One block covers one frame and one TH x TW output tile.  It stages the
// input tile with a 2-pixel halo in shared memory (zero outside the image),
// computes conv1 + PReLU (in float32, one cast) on the tile plus a 1-pixel
// halo into a second shared buffer, and sets that intermediate to zero
// wherever it lies outside the image: each reference conv zero-pads its own
// input, so conv1 evaluated at image row -1 must not leak into conv2.
// conv2 then writes s, and the block writes the channel sums of its tile
// (of s as stored, in float32, in a fixed order) to its own row of a
// (T, n_blocks, C) buffer: no atomics, so the sums are deterministic, and
// the caller reduces the buffer.
//
// What bounds it: arithmetic, 18 C^2 multiply-adds per output pixel (plus
// conv1's halo), against 2 C values a pixel in and out.
//
// Both convs run on the tensor cores (cab_front_mma_kernel): conv_core.cuh's
// implicit GEMM on mma.sync, bfloat16 products in bfloat16 and 3xTF32 in
// float32.  The input tile and the intermediate are pixel-major
// ([pixel][mma_pitch(C)]), so a tap is a row offset; conv1's epilogue
// writes the intermediate straight into the layout conv2's fragments read,
// and conv2's epilogue writes s channel-major over the dead input tile,
// whence it goes to device memory in 16-byte stores and into the sums.
// The weights are packed on the host as [9][Np][KP] in the activations'
// type (ops/chw.py, pack_taps); panels stream one tap at a time where the
// whole conv does not fit in kResidentBytes.  The wrapper picks the tile
// per C and type (ops/chw.py, cab_front_tile).
#include "conv_core.cuh"

namespace shiftnet {

constexpr int kSbufPad = 8;  // s tile: channel planes TH * TW + 8 apart

// m16 fragments a warp holds per pass in conv1 and conv2, sized so that
// each conv of the tile ops/chw.py picks is one pass, or nearly, where the
// registers allow (tools/bench_conv.py --tiles measured each choice): the
// wide forms (two warp columns, up to 5 n8 tiles each) take 3 in conv1, so
// an 8 x 16 tile's 10 x 18 conv1 region (12 fragments) is one pass of
// 4 x 3; the narrow ones take 5 and 4 in bfloat16 (C <= 24 at 16 x 32: 39
// and 32 fragments over 8 warps) and 3 and 2 in float32 (C <= 16 at 8 x 32:
// 22 and 16 fragments; at C = 24 the split fragments leave no room).
template <typename T, int NTW, int WN>
struct CabMfw {
  static constexpr bool wide = WN == 2 && NTW <= 5;
  static constexpr bool narrow = WN == 1 && NTW <= (sizeof(T) == 2 ? 3 : 2);
  static constexpr int conv1 =
      narrow ? (sizeof(T) == 2 ? 5 : 3) : (wide ? 3 : 2);
  static constexpr int conv2 = narrow && sizeof(T) == 2 ? 4 : 2;
};

template <typename T>
__host__ __device__ inline size_t cab_front_smem(int C, int Np, int KP,
                                                 int TH, int TW) {
  return ((size_t)(TH + 4) * (TW + 4) + (size_t)(TH + 2) * (TW + 2)) *
             core::mma_pitch<T>(C) * sizeof(T) +
         core::weight_smem<T>(9, Np, KP);
}

// Two blocks an SM in bfloat16 (128 registers a thread); float32's tiles
// take one.
template <typename T, int NTW, int WN>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    cab_front_mma_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                         const float* __restrict__ alpha,
                         const T* __restrict__ w2, T* __restrict__ s,
                         float* __restrict__ sums, int C, int Np, int KP,
                         int H, int W, int TH, int TW, int tiles_x) {
  constexpr int CH = core::chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IH = TH + 4, IW = TW + 4;  // input tile, 2-pixel halo
  const int MH = TH + 2, MW = TW + 2;  // intermediate, 1-pixel halo
  const int sp = core::mma_pitch<T>(C), kc = core::pad_chunk<T>(C);
  T* xin = reinterpret_cast<T*>(smem_raw);
  T* mid = xin + (size_t)IH * IW * sp;
  T* wbuf = mid + (size_t)MH * MW * sp;
  T* sbuf = xin;  // s, channel-major; reuses xin once conv1 is done
  const int sbp = TH * TW + kSbufPad;

  const int t = blockIdx.z;
  const int tile = blockIdx.x;
  const int n_blocks = gridDim.x;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const size_t plane = (size_t)H * W;

  core::stage_tile(xin, sp, x + (size_t)t * C * plane, C, H, W, y0 - 2,
                   x0 - 2, IH, IW);
  const float a = alpha[0];
  // conv1 + PReLU on the tile plus its 1-pixel halo; zero outside the
  // image, and in the channels past C (their weights are zero).
  core::conv_tile<T, NTW, WN, CabMfw<T, NTW, WN>::conv1>(
      xin, sp, kc, w1, wbuf, 3, IW, Np, KP, MH * MW,
      [&](int p) { return (p / MW) * IW + p % MW; },
      [&](int p, int co, float v0, float v1) {
        if (co >= kc) return;
        const int gy = y0 - 1 + p / MW, gx = x0 - 1 + p % MW;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        core::store2(mid + (size_t)p * sp + co, in ? prelu(v0, a) : 0.f,
                     in ? prelu(v1, a) : 0.f);
      });
  // conv2 into the s tile (zero outside the image).
  core::conv_tile<T, NTW, WN, CabMfw<T, NTW, WN>::conv2>(
      mid, sp, kc, w2, wbuf, 3, MW, Np, KP, TH * TW,
      [&](int p) { return (p / TW) * MW + p % TW; },
      [&](int p, int co, float v0, float v1) {
        const int r = p / TW;
        const bool in = y0 + r < H && x0 + p - r * TW < W;
        if (co < C) sbuf[co * sbp + p] = from_f<T>(in ? v0 : 0.f);
        if (co + 1 < C) sbuf[(co + 1) * sbp + p] = from_f<T>(in ? v1 : 0.f);
      });
  __syncthreads();
  core::store_tile_and_sums(sbuf, sbp, s + (size_t)t * C * plane, C, H, W, y0,
                            x0, TH, TW,
                            sums + ((size_t)t * n_blocks + tile) * C);
}

template <typename T>
static int launch_cab_front(const void* x, const void* w1, const void* alpha,
                            const void* w2, void* s, void* sums, int T_,
                            int C, int Np, int KP, int H, int W, int TH,
                            int TW, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int sp = core::mma_pitch<T>(C);
  // The s tile must fit over the input tile, and rows be 16-byte vectors.
  if (KP != sp || Np < core::pad_chunk<T>(C) || TW % 8 != 0 ||
      (size_t)C * (TH * TW + kSbufPad) > (size_t)(TH + 4) * (TW + 4) * sp)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cab_front_smem<T>(C, Np, KP, TH, TW);
  return core::dispatch_np(Np, [&](auto ntw, auto wn) {
    auto kern =
        cab_front_mma_kernel<T, decltype(ntw)::value, decltype(wn)::value>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(tiles_x * tiles_y, 1, T_);
    kern<<<grid, core::kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const float*>(alpha), static_cast<const T*>(w2),
        static_cast<T*>(s), static_cast<float*>(sums), C, Np, KP, H, W, TH,
        TW, tiles_x);
    return (int)cudaGetLastError();
  });
}

}  // namespace shiftnet

// w1, w2: packed [9][Np][KP] in x's type (ops/chw.py, pack_taps), KP =
// mma_pitch(C); alpha: float32.
extern "C" int shiftnet_cab_front(int dtype, const void* x, const void* w1,
                                  const void* alpha, const void* w2, void* s,
                                  void* sums, int T, int C, int Np, int KP,
                                  int H, int W, int TH, int TW,
                                  void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_cab_front<__nv_bfloat16>(x, w1, alpha, w2, s, sums, T, C,
                                           Np, KP, H, W, TH, TW, st);
  if (dtype == kF32)
    return launch_cab_front<float>(x, w1, alpha, w2, s, sums, T, C, Np, KP,
                                   H, W, TH, TW, st);
  return (int)cudaErrorInvalidValue;
}
