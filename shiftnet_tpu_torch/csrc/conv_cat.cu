// Kernel I, conv_cat: a 3x3 stride-1 convolution over the virtual channel
// concat of n_in in {2, 3} inputs of one shape, with optional float32 bias
// and optional PReLU applied in float32 before the single cast to the output
// type.
//
// Replaces shiftnet_tpu/ops/chw.py:_conv_cat_kernel (conv_concat_chw).  With
// GShiftNetConfig.conv_concat it runs rconcat (3 x 24 -> 24 channels) and
// Encoder2's conv_hr0 (2 x 24 -> 24) at full resolution, so the 72- and
// 48-channel concats of those two convs are never allocated.
//
// A conv is linear in its input channels: conv(cat(x_0, .., x_n-1)) is the
// sum over the inputs of each input's conv with its slice of the weights.
// One block covers one frame, a 16 x 16 output tile and COB = 8 output
// channels; each thread owns one output pixel and keeps its 8 float32 sums
// in registers across all the inputs.  The block walks the inputs in turn
// and stages each one's channels 8 at a time through shared memory: the
// tile with its 1-pixel halo (zero outside the image) and the matching
// weights.  The concat exists neither in device memory nor in shared
// memory.  (The TPU kernel's phase packing, lane tails and DMA semaphores
// are the TPU's layout and are not carried over.)
//
// What bounds it: arithmetic on the CUDA cores, 9 * n_in * Cin multiply-adds
// per output value.  The weights are staged with the output channel minor,
// so two 16-byte shared loads feed a thread's 8 sums for one tap.
#include "common.cuh"

namespace shiftnet {

constexpr int kCatTile = 16;
constexpr int kCatCob = 8;
constexpr int kCatCic = 8;
constexpr int kCatMaxIn = 3;
constexpr int kCatIt = kCatTile + 2;  // input tile edge with its halo

template <typename T>
struct CatInputs {
  const T* x[kCatMaxIn];
};

template <typename T>
__global__ void conv_cat_kernel(CatInputs<T> in, int n_in,
                                const T* __restrict__ w,
                                const float* __restrict__ bias,
                                const float* __restrict__ alpha,
                                T* __restrict__ out, int Cin, int Cout, int H,
                                int W, int tiles_x) {
  __shared__ float xs[kCatCic][kCatIt][kCatIt];
  __shared__ __align__(16) float ws[kCatCic][9][kCatCob];

  const int t = blockIdx.z;
  const int co0 = blockIdx.y * kCatCob;
  const int oy0 = (blockIdx.x / tiles_x) * kCatTile;
  const int ox0 = (blockIdx.x % tiles_x) * kCatTile;
  const int ty = threadIdx.x / kCatTile, tx = threadIdx.x % kCatTile;
  const size_t plane = (size_t)H * W;
  const int cin_all = n_in * Cin;

  float acc[kCatCob];
#pragma unroll
  for (int j = 0; j < kCatCob; ++j) acc[j] = 0.f;

  for (int src = 0; src < n_in; ++src) {
    const T* xt = in.x[src] + (size_t)t * Cin * plane;
    for (int ci0 = 0; ci0 < Cin; ci0 += kCatCic) {
      for (int i = threadIdx.x; i < kCatCic * kCatIt * kCatIt;
           i += blockDim.x) {
        const int c = i / (kCatIt * kCatIt);
        const int rq = i - c * kCatIt * kCatIt;
        const int gy = oy0 - 1 + rq / kCatIt, gx = ox0 - 1 + rq % kCatIt;
        float v = 0.f;
        if (ci0 + c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f(xt[(ci0 + c) * plane + (size_t)gy * W + gx]);
        xs[c][rq / kCatIt][rq % kCatIt] = v;
      }
      for (int i = threadIdx.x; i < kCatCob * kCatCic * 9; i += blockDim.x) {
        const int j = i / (kCatCic * 9);
        const int rem = i - j * kCatCic * 9;
        const int c = rem / 9, k = rem % 9;
        float v = 0.f;
        if (co0 + j < Cout && ci0 + c < Cin)
          v = to_f(w[((size_t)(co0 + j) * cin_all + src * Cin + ci0 + c) * 9 +
                     k]);
        ws[c][k][j] = v;
      }
      __syncthreads();
#pragma unroll 1
      for (int c = 0; c < kCatCic; ++c) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float v = xs[c][ty + ky][tx + kx];
            const float4* wp =
                reinterpret_cast<const float4*>(&ws[c][ky * 3 + kx][0]);
            const float4 a = wp[0], b = wp[1];
            acc[0] = fmaf(a.x, v, acc[0]);
            acc[1] = fmaf(a.y, v, acc[1]);
            acc[2] = fmaf(a.z, v, acc[2]);
            acc[3] = fmaf(a.w, v, acc[3]);
            acc[4] = fmaf(b.x, v, acc[4]);
            acc[5] = fmaf(b.y, v, acc[5]);
            acc[6] = fmaf(b.z, v, acc[6]);
            acc[7] = fmaf(b.w, v, acc[7]);
          }
      }
      __syncthreads();
    }
  }

  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= H || ox >= W) return;
  const float a = alpha ? alpha[0] : 0.f;
  T* ot = out + (size_t)t * Cout * plane + (size_t)oy * W + ox;
#pragma unroll
  for (int j = 0; j < kCatCob; ++j) {
    const int co = co0 + j;
    if (co >= Cout) break;
    float v = acc[j];
    if (bias) v += bias[co];
    if (alpha) v = prelu(v, a);
    ot[co * plane] = from_f<T>(v);
  }
}

template <typename T>
static int launch_conv_cat(const void* x0, const void* x1, const void* x2,
                           int n_in, const void* w, const void* bias,
                           const void* alpha, void* out, int T_, int Cin,
                           int Cout, int H, int W, cudaStream_t stream) {
  if (n_in < 2 || n_in > kCatMaxIn) return (int)cudaErrorInvalidValue;
  CatInputs<T> in{{static_cast<const T*>(x0), static_cast<const T*>(x1),
                   static_cast<const T*>(x2)}};
  const int tiles_x = (W + kCatTile - 1) / kCatTile;
  const int tiles_y = (H + kCatTile - 1) / kCatTile;
  dim3 grid(tiles_x * tiles_y, (Cout + kCatCob - 1) / kCatCob, T_);
  conv_cat_kernel<T><<<grid, kCatTile * kCatTile, 0, stream>>>(
      in, n_in, static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<T*>(out), Cin, Cout, H, W,
      tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// x2 is null when n_in = 2.  w is (Cout, n_in * Cin, 3, 3) in the inputs'
// type: input src's weights are channels [src * Cin, (src + 1) * Cin).  bias
// and alpha are float32 device pointers, or null when absent.
extern "C" int shiftnet_conv_cat(int dtype, const void* x0, const void* x1,
                                 const void* x2, int n_in, const void* w,
                                 const void* bias, const void* alpha,
                                 void* out, int T, int Cin, int Cout, int H,
                                 int W, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_conv_cat<__nv_bfloat16>(x0, x1, x2, n_in, w, bias, alpha,
                                          out, T, Cin, Cout, H, W, st);
  if (dtype == kF32)
    return launch_conv_cat<float>(x0, x1, x2, n_in, w, bias, alpha, out, T,
                                  Cin, Cout, H, W, st);
  return (int)cudaErrorInvalidValue;
}
