// Kernel A, cab_front: the plain CAB body conv3x3 -> PReLU -> conv3x3
// (bias-free) plus per-block channel sums of its output.
//
// Replaces shiftnet_tpu/ops/chw.py:_cab_front_kernel (flat layout) and
// chw.py:_cab_front_s2d_kernel (phase-packed layouts): both compute the
// same function, and the packing existed only for the TPU's layout rules.
//
// One block covers one frame and one TH x TW output tile.  It stages the
// input tile with a 2-pixel halo in shared memory (zero outside the image),
// computes conv1 + PReLU on the tile plus a 1-pixel halo into a second
// shared buffer, and sets that intermediate to zero wherever it lies outside
// the image: each reference conv zero-pads its own input, so conv1 evaluated
// at image row -1 must not leak into conv2.  conv2 then writes s, and the
// block writes the channel sums of its tile (of s as stored, in float32) to
// its own row of a (T, n_blocks, C) buffer: no atomics, so the sums are
// deterministic, and the caller reduces the buffer.
//
// Shared memory per block: C * ((TH+4)(TW+4) + (TH+2)(TW+2)) + 16 elements.
// At 16 x 16 that is 724 C + 16: 69.5 KB at C = 48 in bf16, 139 KB in f32;
// C = 80 (Encoder2's CABs) takes 116 KB in bf16 and 231,744 B in f32, just
// under the 232,448 B a block may use.  The wrapper (ops/chw.py,
// cab_front_tile) drops to 8 x 16 where 16 x 16 does not fit.
//
// What bounds it: arithmetic, 18 C^2 multiply-adds per output pixel on the
// CUDA cores (no tensor cores yet).  The design keeps both convs' inputs in
// shared memory (x is read from device memory once, and the intermediate
// never goes there), and gives each thread 8 output channels of 4 adjacent
// pixels: per input channel and tap it loads 8 weights as two 16-byte
// loads (the wrapper lays the weights out as float32 [Cin][9][Cout]) and 6
// activations per row from shared memory, for 32 multiply-adds, so the
// loads no longer bound the loop.  Tensor-core (wgmma) tiles are later
// work.
#include "common.cuh"

namespace shiftnet {

constexpr int kCabCob = 8;     // output channels per thread
constexpr int kCabPx = 4;      // adjacent output pixels per thread
constexpr int kCabThreads = 192;
// A thread's last 4-pixel chunk may run past its row; the extra reads land
// in the next row or, at the end of a buffer, in this slack.
constexpr int kCabSlack = 16;

// 3x3 conv over a shared-memory tile src[C][SH][SW]: output (r, q) of an
// OH x OW region reads src rows r..r+2, columns q..q+2.  wt holds float32
// weights [C][9][Cp], Cp = C rounded up to kCabCob, zero-padded.  Calls
// epi(co, r, q, acc) for every output channel co < C and position.
template <typename T, typename Epi>
__device__ __forceinline__ void conv3x3_smem(const T* src, int SH, int SW,
                                             const float* __restrict__ wt,
                                             int C, int Cp, int OH, int OW,
                                             Epi epi) {
  const int nchunk = (OW + kCabPx - 1) / kCabPx;
  const int npos = OH * nchunk;
  const int items = (Cp / kCabCob) * npos;
  const int plane = SH * SW;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int g = i / npos;
    const int p = i - g * npos;
    const int r = p / nchunk;
    const int q0 = (p - r * nchunk) * kCabPx;
    float acc[kCabCob][kCabPx];
#pragma unroll
    for (int j = 0; j < kCabCob; ++j)
#pragma unroll
      for (int u = 0; u < kCabPx; ++u) acc[j][u] = 0.f;
    const T* sp = src + r * SW + q0;
    const float* wp = wt + g * kCabCob;
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float v[kCabPx + 2];
#pragma unroll
        for (int u = 0; u < kCabPx + 2; ++u) v[u] = to_f(sp[ky * SW + u]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* w4 =
              reinterpret_cast<const float4*>(wp + (ci * 9 + ky * 3 + kx) * Cp);
          const float4 wa = w4[0], wb = w4[1];
          const float w[kCabCob] = {wa.x, wa.y, wa.z, wa.w,
                                    wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kCabCob; ++j)
#pragma unroll
            for (int u = 0; u < kCabPx; ++u)
              acc[j][u] = fmaf(w[j], v[u + kx], acc[j][u]);
        }
      }
      sp += plane;
    }
#pragma unroll
    for (int j = 0; j < kCabCob; ++j) {
      const int co = g * kCabCob + j;
      if (co >= C) break;
#pragma unroll
      for (int u = 0; u < kCabPx; ++u)
        if (q0 + u < OW) epi(co, r, q0 + u, acc[j][u]);
    }
  }
}

template <typename T>
__global__ void cab_front_kernel(const T* __restrict__ x,
                                 const float* __restrict__ w1,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ w2,
                                 T* __restrict__ s, float* __restrict__ sums,
                                 int C, int Cp, int H, int W, int TH, int TW,
                                 int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IH = TH + 4, IW = TW + 4;  // input tile, 2-pixel halo
  const int MH = TH + 2, MW = TW + 2;  // intermediate, 1-pixel halo
  T* xin = reinterpret_cast<T*>(smem_raw);
  T* mid = xin + (size_t)C * IH * IW;
  T* sbuf = xin;  // s tile for the sums; reuses xin once conv1 is done

  const int t = blockIdx.z;
  const int tile = blockIdx.x;
  const int n_blocks = gridDim.x;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const size_t plane = (size_t)H * W;
  const T* xt = x + (size_t)t * C * plane;

  for (int i = threadIdx.x; i < C * IH * IW; i += blockDim.x) {
    const int c = i / (IH * IW);
    const int rq = i - c * IH * IW;
    const int gy = y0 - 2 + rq / IW;
    const int gx = x0 - 2 + rq % IW;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xt[c * plane + (size_t)gy * W + gx];
    xin[i] = v;
  }
  __syncthreads();

  const float a = alpha[0];
  // conv1 + PReLU on the tile plus its 1-pixel halo; zero outside the image.
  conv3x3_smem<T>(xin, IH, IW, w1, C, Cp, MH, MW,
                  [&](int co, int r, int q, float acc) {
                    const int gy = y0 - 1 + r, gx = x0 - 1 + q;
                    const bool in_image = gy >= 0 && gy < H && gx >= 0 && gx < W;
                    mid[(co * MH + r) * MW + q] =
                        in_image ? from_f<T>(prelu(acc, a)) : from_f<T>(0.f);
                  });
  __syncthreads();

  // conv2 into s; the tile's values also go to sbuf (zero outside the image).
  T* st = s + (size_t)t * C * plane;
  conv3x3_smem<T>(mid, MH, MW, w2, C, Cp, TH, TW,
                  [&](int co, int r, int q, float acc) {
                    const bool in_image = y0 + r < H && x0 + q < W;
                    const T v = in_image ? from_f<T>(acc) : from_f<T>(0.f);
                    sbuf[(co * TH + r) * TW + q] = v;
                    if (in_image)
                      st[co * plane + (size_t)(y0 + r) * W + (x0 + q)] = v;
                  });
  __syncthreads();

  // Per-channel tile sums in a fixed order: one warp per channel.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < C; c += nwarps) {
    float part = 0.f;
    for (int p = lane; p < TH * TW; p += 32) part += to_f(sbuf[(size_t)c * TH * TW + p]);
    part = warp_sum(part);
    if (lane == 0) sums[((size_t)t * n_blocks + tile) * C + c] = part;
  }
}

template <typename T>
static int launch_cab_front(const void* x, const void* w1, const void* alpha,
                            const void* w2, void* s, void* sums, int T_,
                            int C, int Cp, int H, int W, int TH, int TW,
                            cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const size_t smem =
      ((size_t)C * ((TH + 4) * (TW + 4) + (TH + 2) * (TW + 2)) + kCabSlack) *
      sizeof(T);
  cudaFuncSetAttribute(cab_front_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(tiles_x * tiles_y, 1, T_);
  cab_front_kernel<T><<<grid, kCabThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(alpha), static_cast<const float*>(w2),
      static_cast<T*>(s), static_cast<float*>(sums), C, Cp, H, W, TH, TW,
      tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace shiftnet

// w1, w2: float32 [C][9][Cp] (ops/chw.py, _taps_major); alpha: float32.
extern "C" int shiftnet_cab_front(int dtype, const void* x, const void* w1,
                                  const void* alpha, const void* w2, void* s,
                                  void* sums, int T, int C, int Cp, int H,
                                  int W, int TH, int TW, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_cab_front<__nv_bfloat16>(x, w1, alpha, w2, s, sums, T, C, Cp,
                                           H, W, TH, TW, st);
  if (dtype == kF32)
    return launch_cab_front<float>(x, w1, alpha, w2, s, sums, T, C, Cp, H, W,
                                   TH, TW, st);
  return (int)cudaErrorInvalidValue;
}
