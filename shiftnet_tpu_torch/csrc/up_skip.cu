// Kernel D, up_skip: SkipUpSample, out = bilinear2x(conv1x1(x)) + skip.
//
// Replaces shiftnet_tpu/ops/chw.py:_up_kernel (up_skip_chw).  As there, the
// 1x1 conv runs first, at low resolution (exact by linearity, and 4x fewer
// multiply-adds), and its result is rounded to the activation type before
// the upsample.  The upsample is torch's bilinear scale 2 with
// align_corners=False: output row 2i blends 0.75 * z[i] + 0.25 * z[i - 1],
// row 2i + 1 blends 0.75 * z[i] + 0.25 * z[i + 1], neighbours clamped to
// the image, and the same along columns.  The skip is added in float32 and
// the sum rounded once.
//
// One block covers one frame and an 8 x 16 low-resolution tile.  It
// computes z for all output channels on the tile plus a 1-pixel halo into
// shared memory, storing each halo position at its clamped coordinate, so
// the blend needs no edge cases; then it writes the 16 x 32 output tile.
//
// What bounds it: device memory bandwidth.  Per output element it reads one
// skip value and writes one output; the low-resolution x is a quarter of
// the size and the 1x1 conv is Cin multiply-adds per low-resolution value.
#include "common.cuh"

namespace shiftnet {

constexpr int kUpTh = 8;
constexpr int kUpTw = 16;

template <typename T>
__global__ void up_skip_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               const T* __restrict__ skip, T* __restrict__ out,
                               int Cin, int Cout, int h, int wd, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ZH = kUpTh + 2, ZW = kUpTw + 2;
  T* z = reinterpret_cast<T*>(smem_raw);  // [Cout][ZH][ZW]

  const int t = blockIdx.z;
  const int ly0 = (blockIdx.x / tiles_x) * kUpTh;
  const int lx0 = (blockIdx.x % tiles_x) * kUpTw;
  const size_t lplane = (size_t)h * wd;
  const T* xt = x + (size_t)t * Cin * lplane;

  for (int i = threadIdx.x; i < Cout * ZH * ZW; i += blockDim.x) {
    const int co = i / (ZH * ZW);
    const int rq = i - co * ZH * ZW;
    const int ly = min(max(ly0 - 1 + rq / ZW, 0), h - 1);
    const int lx = min(max(lx0 - 1 + rq % ZW, 0), wd - 1);
    const T* xp = xt + (size_t)ly * wd + lx;
    const T* wp = w + (size_t)co * Cin;
    float acc = 0.f;
    for (int ci = 0; ci < Cin; ++ci) acc = fmaf(to_f(wp[ci]), to_f(xp[ci * lplane]), acc);
    z[i] = from_f<T>(acc);
  }
  __syncthreads();

  const int H = 2 * h, W = 2 * wd;
  const size_t plane = (size_t)H * W;
  const int OH = 2 * kUpTh, OW = 2 * kUpTw;
  for (int i = threadIdx.x; i < Cout * OH * OW; i += blockDim.x) {
    const int co = i / (OH * OW);
    const int rq = i - co * OH * OW;
    const int oy = rq / OW, ox = rq % OW;
    const int gy = 2 * ly0 + oy, gx = 2 * lx0 + ox;
    if (gy >= H || gx >= W) continue;
    const int rc = (oy >> 1) + 1, rn = (oy & 1) ? rc + 1 : rc - 1;
    const int cc = (ox >> 1) + 1, cn = (ox & 1) ? cc + 1 : cc - 1;
    const T* zc = z + (size_t)co * ZH * ZW;
    // blend rows in the near and the neighbouring column, then the columns
    const float near_col = 0.75f * to_f(zc[rc * ZW + cc]) + 0.25f * to_f(zc[rn * ZW + cc]);
    const float nb_col = 0.75f * to_f(zc[rc * ZW + cn]) + 0.25f * to_f(zc[rn * ZW + cn]);
    const float up = 0.75f * near_col + 0.25f * nb_col;
    const size_t k = ((size_t)t * Cout + co) * plane + (size_t)gy * W + gx;
    out[k] = from_f<T>(up + to_f(skip[k]));
  }
}

template <typename T>
static int launch_up_skip(const void* x, const void* w, const void* skip,
                          void* out, int T_, int Cin, int Cout, int h, int wd,
                          cudaStream_t stream) {
  const int tiles_x = (wd + kUpTw - 1) / kUpTw;
  const int tiles_y = (h + kUpTh - 1) / kUpTh;
  const size_t smem = (size_t)Cout * (kUpTh + 2) * (kUpTw + 2) * sizeof(T);
  cudaFuncSetAttribute(up_skip_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(tiles_x * tiles_y, 1, T_);
  up_skip_kernel<T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(skip), static_cast<T*>(out), Cin, Cout, h, wd,
      tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// x: (T, Cin, h, wd); w: (Cout, Cin); skip, out: (T, Cout, 2h, 2wd).
extern "C" int shiftnet_up_skip(int dtype, const void* x, const void* w,
                                const void* skip, void* out, int T, int Cin,
                                int Cout, int h, int wd, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_up_skip<__nv_bfloat16>(x, w, skip, out, T, Cin, Cout, h, wd,
                                         st);
  if (dtype == kF32)
    return launch_up_skip<float>(x, w, skip, out, T, Cin, Cout, h, wd, st);
  return (int)cudaErrorInvalidValue;
}
