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
// What bounds it: device memory bandwidth.  It reads C channels and writes
// C + add_c, (2C + add_c) * itemsize bytes per pixel: 400 B in bf16 at
// C = 80, 369 MB for a 4-frame 360x640 round, 0.110 ms at 3.35 TB/s.
//
// A pure gather in whole 16-byte units wherever the rows allow it.  Every
// block has one job, worked out from its index with a few divisions (none
// per element):
// - a y block copies 1024 units of one output plane y[t, c] from its source
//   plane of x, four 16-byte loads a thread issued before their stores;
// - an hw block writes 8 rows of one hw plane, a warp a row: the source
//   row r - dy (or zeros), shifted by dx.  dx is a multiple of 4 pixels, so
//   a row is whole 8-byte units in both types (4 bfloat16, 2 float32) and
//   the shift a whole number of them: 16-byte loads where that number is
//   even, two 8-byte loads where it is odd, zero units outside the frame.
// The blocks of a moved plane's hw copy follow the y blocks of that plane,
// so they read its source while it is still in L2: x is read from device
// memory about once.  Rows that are not whole 16-byte units (or pointers
// off the 16-byte grid) take the same jobs element by element.  y is a
// fresh buffer: y[t] reads x[t - 1], so the round cannot run in place.
#include <type_traits>

#include "common.cuh"

namespace shiftnet {

// (dy, dx) of the 16 outer and 8 inner direction groups, in the channel
// order of ops/shift.py (SHIFT_DIRS_OUTER, SHIFT_DIRS_INNER).
__constant__ int kShiftOuter[16][2] = {
    {8, 8},  {8, 4},  {8, 0},  {8, -4},  {8, -8},  {-8, 8}, {-8, 4}, {-8, 0},
    {-8, -4}, {-8, -8}, {4, 8}, {4, -8}, {0, 8},   {0, -8}, {-4, 8}, {-4, -8}};
__constant__ int kShiftInner[8][2] = {{4, 4},  {4, 0},  {4, -4}, {0, 4},
                                      {0, -4}, {-4, 4}, {-4, 0}, {-4, -4}};

constexpr int kRoundThreads = 256;
constexpr int kCopyUnits = 4;                        // a y thread's units
constexpr int kBlockUnits = kRoundThreads * kCopyUnits;
constexpr int kRowsPerBlock = kRoundThreads / 32;    // an hw block's rows

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

// kVec: rows of whole 16-byte units (V = uint4); else single elements.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRoundThreads)
    shift_round_kernel(const T* __restrict__ x, T* __restrict__ y,
                       T* __restrict__ hw, int T_, int C, int H, int W,
                       int number, int reverse, int patch, int ny, int nh) {
  using V = std::conditional_t<kVec, uint4, T>;
  constexpr int E = sizeof(V) / sizeof(T);  // elements a unit
  const int add_c = 8 * number;
  const size_t plane = (size_t)H * W;
  // Moved planes (ny + nh blocks each) first, then the others (ny each).
  int b = blockIdx.x, t, c, part;
  const int moved = T_ * add_c * (ny + nh);
  if (b < moved) {
    const int m = b / (ny + nh);
    part = b - m * (ny + nh);
    t = m / add_c;
    c = m - t * add_c + (reverse ? C - add_c : 0);
  } else {
    b -= moved;
    const int rest = C - add_c, u = b / ny;
    part = b - u * ny;
    t = u / rest;
    c = u - t * rest + (reverse ? 0 : add_c);
  }
  int st, sc;
  temporal_source(t, c, T_, C, reverse, patch, &st, &sc);
  const T* src = x + ((size_t)st * C + sc) * plane;

  if (part < ny) {  // y[t, c]: units part * kBlockUnits + ...
    const V* s = reinterpret_cast<const V*>(src);
    V* d = reinterpret_cast<V*>(y + ((size_t)t * C + c) * plane);
    const int units = (int)(plane / E);
    const int k0 = part * kBlockUnits + threadIdx.x;
    V v[kCopyUnits];
#pragma unroll
    for (int u = 0; u < kCopyUnits; ++u) {
      const int k = k0 + u * kRoundThreads;
      if (k < units) v[u] = s[k];
    }
#pragma unroll
    for (int u = 0; u < kCopyUnits; ++u) {
      const int k = k0 + u * kRoundThreads;
      if (k < units) d[k] = v[u];
    }
    return;
  }

  // hw[t, j], row r, a warp a row.
  const int j = c - (reverse ? C - add_c : 0);
  const int r = (part - ny) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= H) return;
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
  const int sr = r - dy;
  const bool row_in = sr >= 0 && sr < H;
  const T* srow = src + (size_t)(row_in ? sr : 0) * W;
  T* orow = hw + ((size_t)t * add_c + j) * plane + (size_t)r * W;
  if constexpr (kVec) {
    constexpr int HE = 8 / sizeof(T);  // elements an 8-byte unit
    const int nv = W / E, nh8 = W / HE;
    const int du = dx / HE;  // the shift in 8-byte units
    const uint4* s16 = reinterpret_cast<const uint4*>(srow);
    const uint2* s8 = reinterpret_cast<const uint2*>(srow);
    uint4* o16 = reinterpret_cast<uint4*>(orow);
    for (int m0 = lane; m0 < nv; m0 += 32 * kCopyUnits) {
      uint4 v[kCopyUnits];
#pragma unroll
      for (int u = 0; u < kCopyUnits; ++u) {
        const int m = m0 + 32 * u;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (!row_in || m >= nv) continue;
        if (du % 2 == 0) {
          const int k = m - du / 2;
          if (k >= 0 && k < nv) v[u] = s16[k];
        } else {
          const int k = 2 * m - du;  // the first 8-byte source unit
          if (k >= 0 && k < nh8) {
            const uint2 lo = s8[k];
            v[u].x = lo.x;
            v[u].y = lo.y;
          }
          if (k + 1 >= 0 && k + 1 < nh8) {
            const uint2 hi = s8[k + 1];
            v[u].z = hi.x;
            v[u].w = hi.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyUnits; ++u)
        if (m0 + 32 * u < nv) o16[m0 + 32 * u] = v[u];
    }
  } else {
    for (int q = lane; q < W; q += 32) {
      const int sq = q - dx;
      orow[q] = row_in && sq >= 0 && sq < W ? srow[sq] : from_f<T>(0.f);
    }
  }
}

template <typename T>
static int launch_shift_round(const void* x, void* y, void* hw, int T_, int C,
                              int H, int W, int number, int reverse, int patch,
                              cudaStream_t stream) {
  const int add_c = 8 * number;
  if (number < 1 || add_c > C) return (int)cudaErrorInvalidValue;
  const bool vec =
      (W * sizeof(T)) % 16 == 0 &&
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)hw) % 16 == 0;
  const long long units = (long long)H * W / (vec ? 16 / sizeof(T) : 1);
  const long long ny = (units + kBlockUnits - 1) / kBlockUnits;
  const long long nh = (H + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks =
      (long long)T_ * (add_c * (ny + nh) + (C - add_c) * ny);
  if (units > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kern =
      vec ? &shift_round_kernel<T, true> : &shift_round_kernel<T, false>;
  kern<<<(unsigned)blocks, kRoundThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(hw), T_,
      C, H, W, number, reverse, patch, (int)ny, (int)nh);
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
