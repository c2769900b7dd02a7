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
// One block covers one frame and 128 consecutive pixels of its plane: it
// stages s * ca for all n channels in shared memory, and each thread owns
// 8 output channels of 4 pixels (16-byte weight loads, w7 float32 [n][n]
// input-major).  out may alias y: every element of y is read and then
// written by the same thread, and s is a separate tensor, so the block
// writes in place where the caller knows y is dead.
//
// What bounds it: device memory bandwidth in principle, 3n values per
// pixel (480 B in bf16 at n = 80: 1.32 ms per 40-frame 360x640 call at
// 3.35 TB/s), against n * n = 6,400 multiply-adds per pixel on the CUDA
// cores, which is about 2.3x longer at their 67 TFLOP/s.
#include "common.cuh"

namespace shiftnet {

constexpr int kBackPx = 128;
constexpr int kBackCob = 8;
constexpr int kBackPxT = 4;
constexpr int kBackThreads = 256;

template <typename T>
__global__ void naf_back_kernel(const T* y, const T* __restrict__ s,
                                const T* __restrict__ ca,
                                const float* __restrict__ w7,
                                const float* __restrict__ beta,
                                const float* __restrict__ b7, T* out, int n,
                                long long plane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);  // [n][kBackPx]
  const int t = blockIdx.y;
  const long long base = (long long)blockIdx.x * kBackPx;
  const size_t frame = (size_t)t * n * plane;

  for (int i = threadIdx.x; i < n * kBackPx; i += blockDim.x) {
    const int c = i / kBackPx;
    const long long p = base + (i - c * kBackPx);
    T v = from_f<T>(0.f);
    if (p < plane)
      v = from_f<T>(to_f(s[frame + c * plane + p]) *
                    to_f(ca[(size_t)t * n + c]));
    sc[i] = v;
  }
  __syncthreads();

  const int items = (n / kBackCob) * (kBackPx / kBackPxT);
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int grp = i / (kBackPx / kBackPxT);
    const int p0 = (i - grp * (kBackPx / kBackPxT)) * kBackPxT;
    float acc[kBackCob][kBackPxT];
#pragma unroll
    for (int j = 0; j < kBackCob; ++j)
#pragma unroll
      for (int u = 0; u < kBackPxT; ++u) acc[j][u] = 0.f;
    const T* sp = sc + p0;
    const float* wp = w7 + grp * kBackCob;
    for (int ci = 0; ci < n; ++ci) {
      float v[kBackPxT];
#pragma unroll
      for (int u = 0; u < kBackPxT; ++u) v[u] = to_f(sp[u]);
      const float4 wa = reinterpret_cast<const float4*>(wp)[0];
      const float4 wb = reinterpret_cast<const float4*>(wp)[1];
      const float w[kBackCob] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < kBackCob; ++j)
#pragma unroll
        for (int u = 0; u < kBackPxT; ++u)
          acc[j][u] = fmaf(w[j], v[u], acc[j][u]);
      sp += kBackPx;
      wp += n;
    }
#pragma unroll
    for (int j = 0; j < kBackCob; ++j) {
      const int o = grp * kBackCob + j;
      const float bias = b7 ? b7[o] : 0.f;
      const float scale = beta[o];
#pragma unroll
      for (int u = 0; u < kBackPxT; ++u) {
        const long long p = base + p0 + u;
        if (p >= plane) break;
        const size_t k = frame + o * plane + p;
        out[k] = from_f<T>(to_f(y[k]) + (acc[j][u] + bias) * scale);
      }
    }
  }
}

template <typename T>
static int launch_naf_back(const void* y, const void* s, const void* ca,
                           const void* w7, const void* beta, const void* b7,
                           void* out, int T_, int n, long long plane,
                           cudaStream_t stream) {
  const size_t smem = (size_t)n * kBackPx * sizeof(T);
  cudaFuncSetAttribute(naf_back_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((unsigned)((plane + kBackPx - 1) / kBackPx), T_);
  naf_back_kernel<T><<<grid, kBackThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(s),
      static_cast<const T*>(ca), static_cast<const float*>(w7),
      static_cast<const float*>(beta), static_cast<const float*>(b7),
      static_cast<T*>(out), n, plane);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// y, s, out: (T, n, H, W), out may be y; ca: (T, n) in y's type; w7
// float32 [n][n] (input-major); beta float32 [n]; b7 float32 [n] or null.
// n must be a multiple of 8.
extern "C" int shiftnet_naf_back(int dtype, const void* y, const void* s,
                                 const void* ca, const void* w7,
                                 const void* beta, const void* b7, void* out,
                                 int T, int n, long long plane, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_naf_back<__nv_bfloat16>(y, s, ca, w7, beta, b7, out, T, n,
                                          plane, st);
  if (dtype == kF32)
    return launch_naf_back<float>(y, s, ca, w7, beta, b7, out, T, n, plane,
                                  st);
  return (int)cudaErrorInvalidValue;
}
