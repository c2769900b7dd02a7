// Kernel C, conv: a direct K x K convolution, K in {2, 3, 5}, stride 1 or 2,
// with optional float32 bias and optional PReLU applied in float32 before the
// single cast to the output type.  Padding follows the TPU kernel's rule:
// k // 2 at stride 1, and at stride 2 one pixel for K = 3, none otherwise.
//
// Replaces shiftnet_tpu/ops/chw.py:_down_kernel (conv_chw / down_chw).  It
// runs every standalone conv of the four variants: the TFR DownSamples,
// feat_extract, conv_trans, down01, Encoder2's DownSamples, upsample_conv,
// conv_hr0, rconcat and conv_last (Cin 3-80, Cout 3-96).
//
// What bounds it: arithmetic, K^2 Cin Cout multiply-adds per output pixel,
// against (Cin S^2 + Cout) * 2 bytes a pixel in and out; the narrow convs
// (Cin or Cout 3) sit near the memory bound.
//
// It runs on the tensor cores (conv_mma_kernel, conv_core.cuh's implicit
// GEMM on mma.sync; bfloat16 products in bfloat16, 3xTF32 in float32).
// One block covers one frame, a TH x TW output tile and all output
// channels (Cout padded to Np, up to 112): the input tile with its halo is
// staged once, pixel-major, and the taps and the stride are only row
// addresses of the A fragments.  Weights come packed [K*K][Np][KP] in the
// activations' type (ops/chw.py, pack_taps); Cin = 3 pads to one half step
// a tap and Cout = 3 to one n8 tile, both on the same core.  The epilogue
// adds the bias, applies the PReLU in float32 and stores each value once.
#include "conv_core.cuh"

namespace shiftnet {

template <typename T>
__host__ __device__ inline size_t conv_smem(int Cin, int K, int S, int Np,
                                            int KP, int TH, int TW) {
  return (size_t)((TH - 1) * S + K) * ((TW - 1) * S + K) *
             core::mma_pitch<T>(Cin) * sizeof(T) +
         core::weight_smem<T>(K * K, Np, KP);
}

template <typename T, int NTW, int WN>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    conv_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha, T* __restrict__ out,
                    int Cin, int Cout, int H, int W, int Ho, int Wo, int K,
                    int S, int pad, int Np, int KP, int TH, int TW,
                    int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K;
  const int sp = core::mma_pitch<T>(Cin);
  T* xin = reinterpret_cast<T*>(smem_raw);
  T* wbuf = xin + (size_t)IH * IW * sp;

  const int t = blockIdx.z;
  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_x) * TH;
  const int ox0 = (tile % tiles_x) * TW;
  core::stage_tile(xin, sp, x + (size_t)t * Cin * H * W, Cin, H, W,
                   oy0 * S - pad, ox0 * S - pad, IH, IW);
  const float a = alpha ? alpha[0] : 0.f;
  const size_t oplane = (size_t)Ho * Wo;
  T* ot = out + (size_t)t * Cout * oplane;
  core::conv_tile<T, NTW, WN, 2>(
      xin, sp, core::pad_chunk<T>(Cin), w, wbuf, K, IW, Np, KP, TH * TW,
      [&](int p) { return (p / TW) * S * IW + (p % TW) * S; },
      [&](int p, int co, float v0, float v1) {
        const int r = p / TW;
        const int oy = oy0 + r, ox = ox0 + p - r * TW;
        if (oy >= Ho || ox >= Wo) return;
        const float v[2] = {v0, v1};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (co + u >= Cout) break;
          float y = v[u];
          if (bias) y += bias[co + u];
          if (alpha) y = prelu(y, a);
          ot[(co + u) * oplane + (size_t)oy * Wo + ox] = from_f<T>(y);
        }
      });
}

template <typename T>
static int launch_conv(const void* x, const void* w, const void* bias,
                       const void* alpha, void* out, int T_, int Cin,
                       int Cout, int H, int W, int K, int S, int Np, int KP,
                       int TH, int TW, cudaStream_t stream) {
  const int pad = S == 1 ? K / 2 : (K == 3 ? 1 : 0);
  const int Ho = (H + 2 * pad - K) / S + 1;
  const int Wo = (W + 2 * pad - K) / S + 1;
  if (KP != core::mma_pitch<T>(Cin) || Np < core::pad_chunk<T>(Cout) ||
      (K != 2 && K != 3 && K != 5) || (S != 1 && S != 2))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (Wo + TW - 1) / TW;
  const int tiles_y = (Ho + TH - 1) / TH;
  const size_t smem = conv_smem<T>(Cin, K, S, Np, KP, TH, TW);
  return core::dispatch_np(Np, [&](auto ntw, auto wn) {
    auto kern = conv_mma_kernel<T, decltype(ntw)::value, decltype(wn)::value>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(tiles_x * tiles_y, 1, T_);
    kern<<<grid, core::kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(alpha),
        static_cast<T*>(out), Cin, Cout, H, W, Ho, Wo, K, S, pad, Np, KP, TH,
        TW, tiles_x);
    return (int)cudaGetLastError();
  });
}

}  // namespace shiftnet

// w packed [K*K][Np][KP] in x's type (ops/chw.py, pack_taps), KP =
// mma_pitch(Cin), output tile TH x TW.  bias and alpha are float32 device
// pointers, or null when absent.
extern "C" int shiftnet_conv(int dtype, const void* x, const void* w,
                             const void* bias, const void* alpha, void* out,
                             int T, int Cin, int Cout, int H, int W, int K,
                             int S, int Np, int KP, int TH, int TW,
                             void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_conv<__nv_bfloat16>(x, w, bias, alpha, out, T, Cin, Cout,
                                      H, W, K, S, Np, KP, TH, TW, st);
  if (dtype == kF32)
    return launch_conv<float>(x, w, bias, alpha, out, T, Cin, Cout, H, W, K,
                              S, Np, KP, TH, TW, st);
  return (int)cudaErrorInvalidValue;
}
