// Kernel B, cab_back: out[t, c] = x[t, c] + s[t, c] * ca[t, c], the CAB's
// channel-attention scale and residual.
//
// Replaces shiftnet_tpu/ops/chw.py:_cab_back_kernel (called from cab_chw and
// _run_back).  The attention weights ca come from the CALayer MLP over the
// sums of kernel A, run as plain torch between the two kernels.
//
// What bounds it: device memory bandwidth, 2 reads and 1 write per element
// at one multiply and one add.  One block row per (t, c) plane loads its scale once;
// threads walk the plane with neighbouring threads on neighbouring
// addresses.  out may alias x (in place) when the caller knows x is dead:
// each element is read before it is written, by the same thread.
#include "common.cuh"

namespace shiftnet {

template <typename T>
__global__ void cab_back_kernel(const T* x, const T* __restrict__ s,
                                const T* __restrict__ ca, T* out,
                                long long plane) {
  const size_t tc = blockIdx.y;
  const float scale = to_f(ca[tc]);
  const size_t base = tc * (size_t)plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (long long)gridDim.x * blockDim.x) {
    const size_t k = base + (size_t)i;
    // Round the product to T before the add, as x + s * ca does in torch.
    const float prod = to_f(from_f<T>(__fmul_rn(to_f(s[k]), scale)));
    out[k] = from_f<T>(__fadd_rn(to_f(x[k]), prod));
  }
}

template <typename T>
static int launch_cab_back(const void* x, const void* s, const void* ca,
                           void* out, int TC, long long plane,
                           cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (plane + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  dim3 grid((unsigned)blocks, TC);
  cab_back_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(ca), static_cast<T*>(out), plane);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

extern "C" int shiftnet_cab_back(int dtype, const void* x, const void* s,
                                 const void* ca, void* out, int TC,
                                 long long plane, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_cab_back<__nv_bfloat16>(x, s, ca, out, TC, plane, st);
  if (dtype == kF32) return launch_cab_back<float>(x, s, ca, out, TC, plane, st);
  return (int)cudaErrorInvalidValue;
}
