// Kernel B, cab_back: out[t, c] = x[t, c] + s[t, c] * ca[t, c], the CAB's
// channel-attention scale and residual.
//
// Replaces shiftnet_tpu/ops/chw.py:_cab_back_kernel (called from cab_chw and
// _run_back).  The attention weights ca come from the CALayer MLP over the
// sums of kernel A, run as plain torch between the two kernels.
//
// What bounds it: device memory bandwidth, 2 reads and 1 write per element
// at one multiply and one add (0.158 ms at C = 24, 720x1280, T = 4, bf16).
//
// Design.  The work is cut into items: kItemUnits consecutive units of one
// (t, c) plane, so an item's scale ca[t, c] is one load kept in a register.
// A unit is 16 bytes (8 bf16 or 4 float32: the vector route) where the
// plane is a whole number of 16-byte units and the pointers are 16-byte
// aligned, else one element (the element route, for planes such as the
// tests' 19x37 frames); the wrapper (ops/chw.cab_back_route) picks the
// route before the launch.  Each thread loads kUnroll units of x and of s,
// all before its first store, so 2 * kUnroll loads are in flight per
// thread.  The grid is persistent and balanced: about kBlocksPerSm blocks
// an SM, each taking the same number of items (item i of a block is
// blockIdx.x + i * gridDim.x), with no index arithmetic per element.
// kUnroll and kBlocksPerSm were picked on an H100 among 2-8 each, with
// and without streaming (evict-first) loads and stores, which were slower
// at the 720p shapes.
//
// The arithmetic is per element as in the plain version: the product
// rounded to T (__fmul_rn, then the cast), then the add (__fadd_rn) rounded
// to T, so the result is bit for bit cab_back_plain's.  out may alias x (in
// place) when the caller knows x is dead, so neither takes __restrict__:
// every unit is read before it is written, by the same thread.
#include "common.cuh"

namespace shiftnet {

constexpr int kBackThreads = 256;
constexpr int kUnroll = 2;  // units of x and of s in flight per thread
constexpr int kItemUnits = kBackThreads * kUnroll;
constexpr int kBackSms = 132;  // streaming multiprocessors of an H100 SXM
constexpr int kBlocksPerSm = 8;

// out = x + round_T(s * scale), element by element over one unit U of T.
template <typename T, typename U>
__device__ __forceinline__ U back_unit(const U& xv, const U& sv,
                                       float scale) {
  constexpr int n = sizeof(U) / sizeof(T);
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* se = reinterpret_cast<const T*>(&sv);
  U r;
  T* re = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float prod = to_f(from_f<T>(__fmul_rn(to_f(se[j]), scale)));
    re[j] = from_f<T>(__fadd_rn(to_f(xe[j]), prod));
  }
  return r;
}

// units: units of one plane; items: kItemUnits-unit items of one plane.
template <typename T, typename U>
__global__ void __launch_bounds__(kBackThreads)
    cab_back_kernel(const T* x, const T* __restrict__ s,
                    const T* __restrict__ ca, T* out, long long units,
                    int items, int n_items) {
  const U* xu = reinterpret_cast<const U*>(x);
  const U* su = reinterpret_cast<const U*>(s);
  U* ou = reinterpret_cast<U*>(out);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tc = item / items;
    const float scale = to_f(ca[tc]);
    const long long base = (long long)tc * units;
    const long long u0 =
        (long long)(item - tc * items) * kItemUnits + threadIdx.x;
    U xv[kUnroll], sv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + k * kBackThreads;
      if (u < units) {
        xv[k] = xu[base + u];
        sv[k] = su[base + u];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + k * kBackThreads;
      if (u < units) ou[base + u] = back_unit<T, U>(xv[k], sv[k], scale);
    }
  }
}

template <typename T, typename U>
static int launch_cab_back(const void* x, const void* s, const void* ca,
                           void* out, int TC, long long plane,
                           cudaStream_t stream) {
  const long long units = plane / (long long)(sizeof(U) / sizeof(T));
  const long long items = (units + kItemUnits - 1) / kItemUnits;
  const long long n_items = items * TC;
  if (TC < 1 || units < 1 || n_items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // As many blocks as keep kBlocksPerSm an SM, each with the same number
  // of items (one more for some).
  const long long most = (long long)kBackSms * kBlocksPerSm;
  const long long per_block = (n_items + most - 1) / most;
  const long long blocks = (n_items + per_block - 1) / per_block;
  cab_back_kernel<T, U><<<(unsigned)blocks, kBackThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(ca), static_cast<T*>(out), units, (int)items,
      (int)n_items);
  return (int)cudaGetLastError();
}

template <typename T>
static int cab_back_route(int vector, const void* x, const void* s,
                          const void* ca, void* out, int TC, long long plane,
                          cudaStream_t stream) {
  if (!vector)
    return launch_cab_back<T, T>(x, s, ca, out, TC, plane, stream);
  const long long per = 16 / sizeof(T);
  if (plane % per || ((uintptr_t)x | (uintptr_t)s | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  return launch_cab_back<T, uint4>(x, s, ca, out, TC, plane, stream);
}

}  // namespace shiftnet

// vector: 1 for the 16-byte route (the plane a whole number of 16-byte
// units, x, s and out 16-byte aligned), 0 for the element route.
extern "C" int shiftnet_cab_back(int dtype, const void* x, const void* s,
                                 const void* ca, void* out, int TC,
                                 long long plane, int vector, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return cab_back_route<__nv_bfloat16>(vector, x, s, ca, out, TC, plane,
                                         st);
  if (dtype == kF32)
    return cab_back_route<float>(vector, x, s, ca, out, TC, plane, st);
  return (int)cudaErrorInvalidValue;
}
