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
// A job is one frame and a TH x TW low-resolution tile.  The block stages x
// on the tile plus a 1-pixel halo once, channel-major [Cin][cm_pitch(M)]
// (M = (TH + 2) (TW + 2) pixels), each halo position at its clamped
// coordinate, so the blend keeps no edge cases; runs z = w11 . x for the
// whole staged tile on the tensor cores (conv_core.cuh, cm_tile: one tap, K
// = Cin, N = Cout padded to whole n8 tiles, whose padded columns the
// epilogue drops; mma.sync in bfloat16, 3xTF32 in float32); rounds z to
// the activation type into shared memory; then blends and adds the skip in
// passes over the 2TH x 2TW output rows, 16 bytes of skip and out a thread
// where the rows lie on the 16-byte grid.  The panel (w11 packed once per
// weight, ops/chw.py, up_panel) is loaded once per block: blocks are
// persistent.  The wrapper picks the tile (ops/chw.py, up_skip_tile;
// up_skip_smem mirrors the sizes).
//
// What bounds it: device memory bandwidth.  Per output element it reads one
// skip value and writes one output; the low-resolution x is a quarter of
// the size (0.125 ms for 36->24 to 4x720x1280 in bf16 at 3.35 TB/s).  The
// 1x1 is Cin multiply-adds per low-resolution value, on the tensor cores.
// Likely holding it back from the bytes bound (not measured phase by
// phase): a job's serial phases, x staged by 2-byte loads, then the
// product, then the blend, which only the other resident block overlaps.
#include "conv_core.cuh"

namespace shiftnet {

constexpr int kUpBatch = 4;  // output chunks a thread loads before using

template <typename T>
__host__ __device__ inline size_t up_skip_smem(int Cin, int Cout, int Np,
                                               int KP, int TH, int TW) {
  const size_t xp = core::cm_pitch((TH + 2) * (TW + 2));
  return ((core::pad_chunk<T>(Cin) + (size_t)Cout) * xp + (size_t)Np * KP) *
         sizeof(T);
}

template <typename T, int NTW, int WN>
__global__ void __launch_bounds__(core::kThreads, sizeof(T) == 2 ? 2 : 1)
    up_skip_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ skip, T* __restrict__ out,
                       int T_, int Cin, int Cout, int Np, int KP, int h,
                       int wd, int TH, int TW, int tiles_x, int n_tiles,
                       bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CH = core::chunk<T>();
  const int ZH = TH + 2, ZW = TW + 2, M = ZH * ZW;
  const int xp = core::cm_pitch(M);
  const int Kc = core::pad_chunk<T>(Cin);
  T* xs = reinterpret_cast<T*>(smem_raw);  // [Kc][xp]
  T* zs = xs + (size_t)Kc * xp;            // [Cout][xp]
  T* wbuf = zs + (size_t)Cout * xp;        // [Np][KP]
  const int H = 2 * h, W = 2 * wd, OH = 2 * TH, OW = 2 * TW;
  const size_t lplane = (size_t)h * wd, plane = (size_t)H * W;

  core::load_async(wbuf, w, Np * KP);  // the panel, once
  for (int i = threadIdx.x; i < (Kc - Cin) * xp; i += blockDim.x)
    xs[(size_t)Cin * xp + i] = from_f<T>(0.f);  // padding channels, once
  for (int job = blockIdx.x; job < T_ * n_tiles; job += gridDim.x) {
    const int t = job / n_tiles, tile = job - t * n_tiles;
    const int ly0 = (tile / tiles_x) * TH, lx0 = (tile % tiles_x) * TW;
    const T* xt = x + (size_t)t * Cin * lplane;
    __syncthreads();  // the last job's blend is done with zs, cm_tile with xs
    // x on the tile and its halo, clamped: a thread takes a pixel and its
    // channels, 8 loads in flight before their stores.
    for (int lp = threadIdx.x; lp < M; lp += blockDim.x) {
      const int r = lp / ZW, q = lp - r * ZW;
      const int ly = min(max(ly0 - 1 + r, 0), h - 1);
      const int lx = min(max(lx0 - 1 + q, 0), wd - 1);
      const T* src = xt + (size_t)ly * wd + lx;
      for (int c0 = 0; c0 < Cin; c0 += 8) {
        T v[8];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (c0 + b < Cin) v[b] = src[(size_t)(c0 + b) * lplane];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (c0 + b < Cin) xs[(size_t)(c0 + b) * xp + lp] = v[b];
      }
    }
    core::wait_async();
    __syncthreads();
    core::cm_tile<T, NTW, WN, WN, false>(
        xs, xp, Kc, wbuf, KP, M, nullptr,
        [&](int p, int, int co, float v0, float v1) {
          if (co < Cout) zs[(size_t)co * xp + p] = from_f<T>(v0);
          if (co + 1 < Cout) zs[(size_t)(co + 1) * xp + p] = from_f<T>(v1);
        });
    __syncthreads();

    const T* skt = skip + (size_t)t * Cout * plane;
    T* ot = out + (size_t)t * Cout * plane;
    const int gy0 = 2 * ly0, gx0 = 2 * lx0;
    if (vec) {
      // Items of CH output pixels of one row, a thread at one position ox
      // of every row it takes (the block is a multiple of a row's qv
      // items): rows blended first for the CH / 2 + 2 z columns it reads,
      // then the columns.
      const int qv = OW / CH, rows = Cout * OH, step = blockDim.x / qv;
      const int ox = (threadIdx.x % qv) * CH;
      const bool col_in = gx0 + ox < W;
      for (int r0 = threadIdx.x / qv; r0 < rows; r0 += step * kUpBatch) {
        uint4 sk[kUpBatch];
#pragma unroll
        for (int b = 0; b < kUpBatch; ++b) {
          const int rr = r0 + b * step, co = rr / OH, oy = rr - co * OH;
          if (col_in && rr < rows && gy0 + oy < H)
            sk[b] = *reinterpret_cast<const uint4*>(
                skt + (size_t)co * plane + (size_t)(gy0 + oy) * W + gx0 + ox);
        }
#pragma unroll
        for (int b = 0; b < kUpBatch; ++b) {
          const int rr = r0 + b * step, co = rr / OH, oy = rr - co * OH;
          if (!col_in || rr >= rows || gy0 + oy >= H) continue;
          const int rc = (oy >> 1) + 1, rn = (oy & 1) ? rc + 1 : rc - 1;
          const T* zc = zs + (size_t)co * xp + rc * ZW + (ox >> 1);
          const T* zn = zs + (size_t)co * xp + rn * ZW + (ox >> 1);
          float col[CH / 2 + 2];
#pragma unroll
          for (int j = 0; j < CH / 2 + 2; ++j)
            col[j] = 0.75f * to_f(zc[j]) + 0.25f * to_f(zn[j]);
          const T* sv = reinterpret_cast<const T*>(&sk[b]);
          uint4 res;
          T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const int c = (u >> 1) + 1, cn = (u & 1) ? c + 1 : c - 1;
            const float up = 0.75f * col[c] + 0.25f * col[cn];
            rv[u] = from_f<T>(up + to_f(sv[u]));
          }
          *reinterpret_cast<uint4*>(ot + (size_t)co * plane +
                                    (size_t)(gy0 + oy) * W + gx0 + ox) = res;
        }
      }
    } else {
      for (int i = threadIdx.x; i < Cout * OH * OW; i += blockDim.x) {
        const int co = i / (OH * OW), rq = i - co * OH * OW;
        const int oy = rq / OW, ox = rq - oy * OW;
        const int gy = gy0 + oy, gx = gx0 + ox;
        if (gy >= H || gx >= W) continue;
        const int rc = (oy >> 1) + 1, rn = (oy & 1) ? rc + 1 : rc - 1;
        const int cc = (ox >> 1) + 1, cn = (ox & 1) ? cc + 1 : cc - 1;
        const T* zc = zs + (size_t)co * xp;
        const float near_col = 0.75f * to_f(zc[rc * ZW + cc]) +
                               0.25f * to_f(zc[rn * ZW + cc]);
        const float nb_col = 0.75f * to_f(zc[rc * ZW + cn]) +
                             0.25f * to_f(zc[rn * ZW + cn]);
        const float up = 0.75f * near_col + 0.25f * nb_col;
        const size_t k = (size_t)co * plane + (size_t)gy * W + gx;
        ot[k] = from_f<T>(up + to_f(skt[k]));
      }
    }
  }
  core::wait_async();
}

template <typename T>
static int launch_up_skip(const void* x, const void* w, const void* skip,
                          void* out, int T_, int Cin, int Cout, int Np,
                          int KP, int h, int wd, int TH, int TW, bool vec,
                          cudaStream_t stream) {
  if (TW % 4 || TH < 1 || Cout > Np || KP < core::pad_chunk<T>(Cin) ||
      core::kThreads % (2 * TW / core::chunk<T>()))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (wd + TW - 1) / TW;
  const int n_tiles = tiles_x * ((h + TH - 1) / TH);
  const size_t smem = up_skip_smem<T>(Cin, Cout, Np, KP, TH, TW);
  return core::dispatch_np(Np, [&](auto ntw, auto wn) {
    auto kern = up_skip_mma_kernel<T, decltype(ntw)::value,
                                   decltype(wn)::value>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int jobs = T_ * n_tiles;
    const int blocks = core::persistent_grid(kern, smem, jobs, jobs);
    kern<<<blocks, core::kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(skip), static_cast<T*>(out), T_, Cin, Cout, Np,
        KP, h, wd, TH, TW, tiles_x, n_tiles, vec);
    return (int)cudaGetLastError();
  });
}

}  // namespace shiftnet

// x: (T, Cin, h, wd); w: w11's panel [Np][KP] in x's type (output channels
// on the rows, ops/chw.py, up_panel); skip, out: (T, Cout, 2h, 2wd).  TW a
// multiple of 4; vec: 2wd a multiple of 16 bytes' elements and skip, out on
// the 16-byte grid (16-byte blend items), else element items.
extern "C" int shiftnet_up_skip(int dtype, const void* x, const void* w,
                                const void* skip, void* out, int T, int Cin,
                                int Cout, int Np, int KP, int h, int wd,
                                int TH, int TW, int vec, void* stream) {
  using namespace shiftnet;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_up_skip<__nv_bfloat16>(x, w, skip, out, T, Cin, Cout, Np,
                                         KP, h, wd, TH, TW, vec != 0, st);
  if (dtype == kF32)
    return launch_up_skip<float>(x, w, skip, out, T, Cin, Cout, Np, KP, h,
                                 wd, TH, TW, vec != 0, st);
  return (int)cudaErrorInvalidValue;
}
