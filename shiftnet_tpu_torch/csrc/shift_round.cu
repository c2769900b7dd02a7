// Kernel E, shift_round: one grouped spatial-temporal shift (GSTS) round of
// an Encoder shift block, equal bit for bit to ops/shift.py:gsts.
//
// Replaces shiftnet_tpu/ops/naf_chw.py:_shift_round_kernel (shift_round_chw).
//
//   y[t]  = cat(x[t-1][C/2:], x[t][:C/2])   forward (frame 0 wraps to T-1)
//   y[t]  = cat(x[t][C/2:], x[t+1][:C/2])   reverse (frame T-1 wraps to 0)
//           with the boundary patch, the wrapped frame is x's own frame;
//   hw    = the add_c = 8 * number moved channels of y (the front ones going
//           forward, the back ones in reverse), each direction group
//           translated by its (dy, dx) in {0, +-4, +-8} with zero fill:
//           hw[j](r, q) = y[c_j](r - dy, q - dx).
//
// A pure gather: every output plane (t, c) of y and of hw is one row of
// the grid, and its source plane is a frame and channel of x computed once
// per block, so hw reads x directly and does not wait for y.  Threads walk
// the plane with neighbouring threads on neighbouring addresses.  y is a
// fresh buffer: y[t] reads x[t - 1], so the round cannot run in place.
//
// What bounds it: device memory bandwidth.  It reads C channels and writes
// C + add_c, (2C + add_c) * itemsize bytes per pixel: 400 B in bf16 at
// C = 80, 3.69 GB for a 40-frame 360x640 round, 1.10 ms at 3.35 TB/s.
#include "common.cuh"

namespace shiftnet {

// (dy, dx) of the 16 outer and 8 inner direction groups, in the channel
// order of ops/shift.py (SHIFT_DIRS_OUTER, SHIFT_DIRS_INNER).
__constant__ int kShiftOuter[16][2] = {
    {8, 8},  {8, 4},  {8, 0},  {8, -4},  {8, -8},  {-8, 8}, {-8, 4}, {-8, 0},
    {-8, -4}, {-8, -8}, {4, 8}, {4, -8}, {0, 8},   {0, -8}, {-4, 8}, {-4, -8}};
__constant__ int kShiftInner[8][2] = {{4, 4},  {4, 0},  {4, -4}, {0, 4},
                                      {0, -4}, {-4, 4}, {-4, 0}, {-4, -4}};

// Frame and channel of x that y[t, c] copies.
__device__ __forceinline__ void temporal_source(int t, int c, int T, int C,
                                                bool reverse, bool patch,
                                                int* st, int* sc) {
  const int cs = C / 2;
  if (!reverse) {
    if (patch && t == 0) { *st = t; *sc = c; return; }
    if (c < cs) { *st = (t + T - 1) % T; *sc = C - cs + c; }
    else { *st = t; *sc = c - cs; }
  } else {
    if (patch && t == T - 1) { *st = t; *sc = c; return; }
    if (c < C - cs) { *st = t; *sc = cs + c; }
    else { *st = (t + 1) % T; *sc = c - (C - cs); }
  }
}

template <typename T>
__global__ void shift_round_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   T* __restrict__ hw, int T_, int C, int H,
                                   int W, int number, int reverse, int patch) {
  const int add_c = 8 * number;
  const int t = blockIdx.y / (C + add_c);
  const int c = blockIdx.y - t * (C + add_c);
  const long long plane = (long long)H * W;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int st, sc;
  if (c < C) {
    temporal_source(t, c, T_, C, reverse, patch, &st, &sc);
    const T* src = x + ((size_t)st * C + sc) * plane;
    T* dst = y + ((size_t)t * C + c) * plane;
    for (long long i = i0; i < plane; i += step) dst[i] = src[i];
    return;
  }
  const int j = c - C;  // channel of hw
  temporal_source(t, reverse ? C - add_c + j : j, T_, C, reverse, patch, &st,
                  &sc);
  const int n2 = (number - 1) / 2;  // channels per outer group
  const int n1 = number - 2 * n2;   // channels per inner group
  int dy, dx;
  if (j < 16 * n2) {
    dy = kShiftOuter[j / n2][0];
    dx = kShiftOuter[j / n2][1];
  } else {
    dy = kShiftInner[(j - 16 * n2) / n1][0];
    dx = kShiftInner[(j - 16 * n2) / n1][1];
  }
  const T* src = x + ((size_t)st * C + sc) * plane;
  T* dst = hw + ((size_t)t * add_c + j) * plane;
  for (long long i = i0; i < plane; i += step) {
    const int r = (int)(i / W), q = (int)(i - (long long)r * W);
    const int sr = r - dy, sq = q - dx;
    dst[i] = (sr >= 0 && sr < H && sq >= 0 && sq < W)
                 ? src[(size_t)sr * W + sq]
                 : from_f<T>(0.f);
  }
}

template <typename T>
static int launch_shift_round(const void* x, void* y, void* hw, int T_, int C,
                              int H, int W, int number, int reverse, int patch,
                              cudaStream_t stream) {
  const int threads = 256;
  long long blocks = ((long long)H * W + threads * 8 - 1) / (threads * 8);
  if (blocks > 64) blocks = 64;
  dim3 grid((unsigned)blocks, T_ * (C + 8 * number));
  shift_round_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(hw), T_,
      C, H, W, number, reverse, patch);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// x, y: (T, C, H, W); hw: (T, 8 * number, H, W); y and hw must not alias x.
extern "C" int shiftnet_shift_round(int dtype, const void* x, void* y,
                                    void* hw, int T, int C, int H, int W,
                                    int number, int reverse, int patch,
                                    void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_shift_round<__nv_bfloat16>(x, y, hw, T, C, H, W, number,
                                             reverse, patch, st);
  if (dtype == kF32)
    return launch_shift_round<float>(x, y, hw, T, C, H, W, number, reverse,
                                     patch, st);
  return (int)cudaErrorInvalidValue;
}
