// Kernel C, conv: a direct K x K convolution, K in {2, 3, 5}, stride 1 or 2,
// with optional float32 bias and optional PReLU applied in float32 before the
// single cast to the output type.  Padding follows the TPU kernel's rule:
// k // 2 at stride 1, and at stride 2 one pixel for K = 3, none otherwise.
//
// Replaces shiftnet_tpu/ops/chw.py:_down_kernel (conv_chw / down_chw).  On
// the TFR U-Net path it runs the stride-2 3x3 DownSample convs with bias
// (24 -> 36 and 36 -> 48 channels).
//
// One block covers one frame, a 16 x 16 output tile and COB = 8 output
// channels; each thread owns one output pixel and keeps its 8 sums in
// registers.  Input channels go through shared memory in chunks of 8: the
// input tile with its halo (zero outside the image) and the matching
// weights, in float32.
//
// What bounds it: arithmetic on the CUDA cores, K^2 Cin multiply-adds per
// output value, each with one shared-memory weight load broadcast to the
// warp.  On this path the convs are a small share of the TFR's work (about
// 2 % of its multiply-adds), so the simple form stays until a measurement
// says otherwise.
#include "common.cuh"

namespace shiftnet {

constexpr int kConvTile = 16;
constexpr int kConvCob = 8;
constexpr int kConvCic = 8;

template <typename T, int K, int S>
__global__ void conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ bias,
                            const float* __restrict__ alpha,
                            T* __restrict__ out, int Cin, int Cout, int H,
                            int W, int Ho, int Wo, int pad, int tiles_x,
                            int co_groups) {
  constexpr int IT = (kConvTile - 1) * S + K;  // input tile edge with halo
  __shared__ float xs[kConvCic][IT][IT];
  __shared__ float ws[kConvCob][kConvCic][K * K];

  const int t = blockIdx.z;
  const int cog = blockIdx.y;
  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_x) * kConvTile;
  const int ox0 = (tile % tiles_x) * kConvTile;
  const int iy0 = oy0 * S - pad, ix0 = ox0 * S - pad;
  const int ty = threadIdx.x / kConvTile, tx = threadIdx.x % kConvTile;
  const int co0 = cog * kConvCob;
  const size_t plane = (size_t)H * W;
  const T* xt = x + (size_t)t * Cin * plane;

  float acc[kConvCob];
#pragma unroll
  for (int j = 0; j < kConvCob; ++j) acc[j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kConvCic) {
    for (int i = threadIdx.x; i < kConvCic * IT * IT; i += blockDim.x) {
      const int c = i / (IT * IT);
      const int rq = i - c * IT * IT;
      const int gy = iy0 + rq / IT, gx = ix0 + rq % IT;
      float v = 0.f;
      if (ci0 + c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xt[(ci0 + c) * plane + (size_t)gy * W + gx]);
      xs[c][rq / IT][rq % IT] = v;
    }
    for (int i = threadIdx.x; i < kConvCob * kConvCic * K * K; i += blockDim.x) {
      const int j = i / (kConvCic * K * K);
      const int rem = i - j * kConvCic * K * K;
      const int c = rem / (K * K), k = rem % (K * K);
      float v = 0.f;
      if (co0 + j < Cout && ci0 + c < Cin)
        v = to_f(w[((size_t)(co0 + j) * Cin + ci0 + c) * K * K + k]);
      ws[j][c][k] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kConvCic; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v = xs[c][ty * S + ky][tx * S + kx];
#pragma unroll
          for (int j = 0; j < kConvCob; ++j)
            acc[j] = fmaf(ws[j][c][ky * K + kx], v, acc[j]);
        }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= Ho || ox >= Wo) return;
  const float a = alpha ? alpha[0] : 0.f;
  const size_t oplane = (size_t)Ho * Wo;
  T* ot = out + (size_t)t * Cout * oplane + (size_t)oy * Wo + ox;
#pragma unroll
  for (int j = 0; j < kConvCob; ++j) {
    const int co = co0 + j;
    if (co >= Cout) break;
    float v = acc[j];
    if (bias) v += bias[co];
    if (alpha) v = prelu(v, a);
    ot[co * oplane] = from_f<T>(v);
  }
}

template <typename T, int K, int S>
static int launch_conv_ks(const void* x, const void* w, const void* bias,
                          const void* alpha, void* out, int T_, int Cin,
                          int Cout, int H, int W, int pad,
                          cudaStream_t stream) {
  const int Ho = (H + 2 * pad - K) / S + 1;
  const int Wo = (W + 2 * pad - K) / S + 1;
  const int tiles_x = (Wo + kConvTile - 1) / kConvTile;
  const int tiles_y = (Ho + kConvTile - 1) / kConvTile;
  const int co_groups = (Cout + kConvCob - 1) / kConvCob;
  dim3 grid(tiles_x * tiles_y, co_groups, T_);
  conv_kernel<T, K, S><<<grid, kConvTile * kConvTile, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(alpha),
      static_cast<T*>(out), Cin, Cout, H, W, Ho, Wo, pad, tiles_x, co_groups);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_conv(const void* x, const void* w, const void* bias,
                       const void* alpha, void* out, int T_, int Cin, int Cout,
                       int H, int W, int K, int S, cudaStream_t st) {
  const int pad = S == 1 ? K / 2 : (K == 3 ? 1 : 0);
#define SHIFTNET_CONV_CASE(KK, SS)                                          \
  if (K == KK && S == SS)                                                   \
    return launch_conv_ks<T, KK, SS>(x, w, bias, alpha, out, T_, Cin, Cout, \
                                     H, W, pad, st);
  SHIFTNET_CONV_CASE(2, 1)
  SHIFTNET_CONV_CASE(2, 2)
  SHIFTNET_CONV_CASE(3, 1)
  SHIFTNET_CONV_CASE(3, 2)
  SHIFTNET_CONV_CASE(5, 1)
  SHIFTNET_CONV_CASE(5, 2)
#undef SHIFTNET_CONV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace shiftnet

// bias and alpha are float32 device pointers, or null when absent.
extern "C" int shiftnet_conv(int dtype, const void* x, const void* w,
                             const void* bias, const void* alpha, void* out,
                             int T, int Cin, int Cout, int H, int W, int K,
                             int S, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_conv<__nv_bfloat16>(x, w, bias, alpha, out, T, Cin, Cout, H,
                                      W, K, S, st);
  if (dtype == kF32)
    return launch_conv<float>(x, w, bias, alpha, out, T, Cin, Cout, H, W, K, S,
                              st);
  return (int)cudaErrorInvalidValue;
}
