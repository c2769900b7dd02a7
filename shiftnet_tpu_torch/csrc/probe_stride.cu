// Probe strided_copy: stride-2 access along the lanes of a (rows, m) bf16
// tensor, in three modes (ops/probes.py, STRIDE_MODES):
//
//   0 lane stride:       out[r, j] = x[r, 2j]
//   1 row-block stride:  out[r, j] = x[r, (j / B) * 2B + j % B], every
//                        other block of B lanes (B = 128)
//   2 strided store:     out[r, 2j] = x[r, j], out[r, 2j + 1] = 0
//
// Replaces tools/probe_chw.py:119 k_lane_stride (mode 0), :135 k_sub_stride
// (mode 1) and :152 k_store (mode 2): the stride-2 slices and the
// interleaving store that a stride-2 conv's input and a 2x upsample's
// output need.
//
// What bounds it: device memory.  Mode 0 reads all of x (its even lanes
// fill every sector) and writes out, half its size; mode 1 reads only the
// blocks it keeps, half of x, and writes out; mode 2 reads x and writes
// out, twice its size.
//
// Design.  Each thread writes 8 consecutive outputs with one 16-byte
// store, neighbouring threads on neighbouring addresses: mode 0 loads the
// 16 inputs they come from as two 16-byte words and keeps the even halves,
// mode 1 loads 8 contiguous inputs of one block as one word (B is a
// multiple of 8), mode 2 loads 4 inputs as one 8-byte word and interleaves
// them with zeros.  The wrapper requires rows of whole 16-byte words.
#include "common.cuh"

namespace shiftnet {

union Word {
  uint4 q;
  uint16_t h[8];
};

__global__ void strided_copy_kernel(const uint16_t* __restrict__ x,
                                    uint16_t* __restrict__ out, int rows,
                                    int m_out, int mode, int B) {
  const long long per_row = m_out / 8;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows * per_row; i += step) {
    const long long r = i / per_row;
    const int o = (int)(i - r * per_row) * 8;  // first output lane
    Word w;
    if (mode == 0) {
      const uint16_t* s = x + r * (2LL * m_out) + 2 * o;
      Word lo, hi;
      lo.q = *reinterpret_cast<const uint4*>(s);
      hi.q = *reinterpret_cast<const uint4*>(s + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w.h[j] = lo.h[2 * j];
        w.h[4 + j] = hi.h[2 * j];
      }
    } else if (mode == 1) {
      const int src = o / B * 2 * B + o % B;
      w.q = *reinterpret_cast<const uint4*>(x + r * (2LL * m_out) + src);
    } else {
      const uint2 v =
          *reinterpret_cast<const uint2*>(x + r * (m_out / 2LL) + o / 2);
      w.q = make_uint4(v.x & 0xffffu, v.x >> 16, v.y & 0xffffu, v.y >> 16);
    }
    *reinterpret_cast<uint4*>(out + r * m_out + o) = w.q;
  }
}

}  // namespace shiftnet

// x: (rows, m_in) and out: (rows, m_out), bf16, 16-byte aligned, with
// m_in = 2 * m_out (modes 0, 1) or m_out / 2 (mode 2).
extern "C" int shiftnet_strided_copy(const void* x, void* out, int rows,
                                     int m_out, int mode, int B,
                                     void* stream) {
  using namespace shiftnet;
  if (mode < 0 || mode > 2 || m_out % 8 || (mode == 1 && B % 8))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = ((long long)rows * (m_out / 8) + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  strided_copy_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), rows,
      m_out, mode, B);
  return (int)cudaGetLastError();
}
