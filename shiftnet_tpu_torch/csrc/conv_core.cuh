// The implicit-GEMM conv core of cab_front and conv: a K x K convolution of
// a tile held in shared memory, on the tensor cores, with float32 sums.
// bfloat16 operands run mma.sync m16n8k16 (and m16n8k8); float32 operands
// run 3xTF32: each operand split into a TF32 high part and a TF32 low part
// (the rounding error of the high part), and a_lo b_hi + a_hi b_lo + a_hi
// b_hi summed on m16n8k8 (and m16n8k4) TF32 products, which keeps float32's
// accuracy where one TF32 product keeps about three decimal digits.  It is
// a device building block, not a kernel: cab_front.cu and conv.cu stage
// their tiles and call conv_tile.
//
// The product.  Output pixels are the M rows, output channels the N
// columns, and (tap, input channel) the K depth: acc[p][co] = sum over taps
// and ci of X[row(p) + off(tap)][ci] * W[tap][co][ci].  The taps are the
// outer K loop, the input channels the inner steps of 32 bytes (k16 in
// bfloat16, k8 in float32), with one half step where they leave 16 bytes
// over (C = 24 in bfloat16 is one k16 and one k8, not two k16), so the
// only padding is to a 16-byte chunk: 8 channels in bfloat16, 4 in float32.
//
// Layouts, and the trouble each avoids.
// - Activations: pixel-major tiles, dst[pixel][pitch], pitch = channels
//   rounded up to a chunk plus a chunk where that is an even number of
//   16-byte units (mma_pitch).  One ldmatrix row is one pixel's chunk of
//   channels, 16 bytes (a float32 fragment is read as pairs of b16), so
//   a tap's shift (and a stride) is only another row address per lane, and
//   the 8 row addresses of one ldmatrix (8 neighbouring pixels) fall in 8
//   distinct 16-byte bank groups.  An NCHW tile would leave a 1-2 pixel
//   shift unaligned.
// - Weights: packed on the host (ops/chw.py, pack_taps) in the operands'
//   type as [tap][Np][KP]: output channel rows, input channels along a
//   row, zero padded, KP = mma_pitch(Cin).  A tap's panel is the B operand
//   as stored [n][k], read by ldmatrix without .trans, conflict-free for
//   the same reason.  Where a conv's panels all fit in kResidentBytes they
//   are loaded once (cp.async); otherwise one tap's panel at a time streams
//   in, double-buffered: the next tap's cp.async is in flight while this
//   tap's products run.  A C = 80 3x3 conv is 127 KB of bfloat16 panels,
//   too much to keep beside a tile's input and intermediate.
// - Work: 8 warps, WM x WN (WN = 1 or 2 along N).  A warp owns MFW m16
//   fragments (16 output pixels each) and NTW n8 tiles, all of its sums in
//   registers across every tap; the M extent is covered in passes of
//   WM * MFW fragments.  No atomics: each output is summed in one fixed
//   order.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace shiftnet {
namespace core {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kResidentBytes = 40960;   // a conv's panels kept whole

typedef __nv_bfloat16 bf16;

// Elements in a 16-byte chunk: 8 bfloat16, 4 float32.
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 16 / (int)sizeof(T);
}

// Channels rounded up to a whole chunk.
template <typename T>
__host__ __device__ inline int pad_chunk(int c) {
  return (c + chunk<T>() - 1) / chunk<T>() * chunk<T>();
}

// Row length (elements) of a pixel-major tile or a weight panel row.
template <typename T>
__host__ __device__ inline int mma_pitch(int c) {
  const int p = pad_chunk<T>(c);
  return (p / chunk<T>()) % 2 ? p : p + chunk<T>();
}

// Shared-memory bytes of a conv's weights: whole, or two tap panels.
template <typename T>
__host__ __device__ inline bool resident(int taps, int Np, int KP) {
  return (size_t)taps * Np * KP * sizeof(T) <= (size_t)kResidentBytes;
}
template <typename T>
__host__ __device__ inline size_t weight_smem(int taps, int Np, int KP) {
  return (resident<T>(taps, Np, KP) ? (size_t)taps : 2) * Np * KP *
         sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x1(uint32_t& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a,
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// TF32 operands of 3xTF32: x = hi + lo, each rounded to TF32.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t* x, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(__uint_as_float(x[i]));
    lo[i] = to_tf32(__uint_as_float(x[i]) - __uint_as_float(hi[i]));
  }
}

// c += a b, or with kZero c = a b (the sums start at zero: no moves to
// clear them).
template <bool kZero = false>
__device__ __forceinline__ void mma_tf32_k8(float* c, const uint32_t* a,
                                            const uint32_t* b) {
  if constexpr (kZero)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kZero = false>
__device__ __forceinline__ void mma_tf32_k4(float* c, const uint32_t* a,
                                            uint32_t b) {
  if constexpr (kZero)
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b), "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
}

// One step of K (32 bytes a row: k16 bf16, k8 tf32; R = 4 A and 2 B
// registers) or half a step (16 bytes: k8, k4; R = 2 and 1): c += a b.
// The float32 operands come split (hi, lo) and take three products, the
// small ones first.
template <typename T, bool kFull>
struct Step;
template <bool kFull>
struct Step<bf16, kFull> {
  static constexpr int kA = kFull ? 4 : 2, kB = kFull ? 2 : 1;
  struct A { uint32_t r[kA]; };
  struct B { uint32_t r[kB]; };
  static __device__ __forceinline__ void load_a(A& a, const uint32_t* x) {
#pragma unroll
    for (int i = 0; i < kA; ++i) a.r[i] = x[i];
  }
  static __device__ __forceinline__ void load_b(B& b, const uint32_t* x) {
#pragma unroll
    for (int i = 0; i < kB; ++i) b.r[i] = x[i];
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    if constexpr (kFull) mma_k16(c, a.r, b.r);
    else mma_k8(c, a.r, b.r[0]);
  }
};
template <bool kFull>
struct Step<float, kFull> {
  static constexpr int kA = kFull ? 4 : 2, kB = kFull ? 2 : 1;
  struct A { uint32_t hi[kA], lo[kA]; };
  struct B { uint32_t hi[kB], lo[kB]; };
  static __device__ __forceinline__ void load_a(A& a, const uint32_t* x) {
    split_tf32<kA>(x, a.hi, a.lo);
  }
  static __device__ __forceinline__ void load_b(B& b, const uint32_t* x) {
    split_tf32<kB>(x, b.hi, b.lo);
  }
  // The three products go into a fresh partial that joins the sums in a
  // float32 add: the tensor cores' own accumulation truncates, and over a
  // whole conv's K (up to 720) that bias reached 7.5e-6 std of the output
  // when every product accumulated in place.
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    float d[4];
    if constexpr (kFull) {
      mma_tf32_k8<true>(d, a.lo, b.hi);
      mma_tf32_k8(d, a.hi, b.lo);
      mma_tf32_k8(d, a.hi, b.hi);
    } else {
      mma_tf32_k4<true>(d, a.lo, b.hi[0]);
      mma_tf32_k4(d, a.hi, b.lo[0]);
      mma_tf32_k4(d, a.hi, b.hi[0]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] += d[r];
  }
};

// n_elems (a multiple of 16 bytes' worth) from global to shared memory, 16
// bytes a thread, asynchronously; one commit group.
template <typename T>
__device__ __forceinline__ void load_async(T* dst, const T* src,
                                           int n_elems) {
  constexpr int CH = chunk<T>();
  for (int i = threadIdx.x * CH; i < n_elems; i += blockDim.x * CH)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst + i)),
                 "l"(src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage frame xt (NCHW plane per channel) rows y0..y0+SH-1, columns
// x0..x0+SW-1 into dst[(r * SW + q) * sp + c] for c < pad_chunk(C): zero
// outside the image and for c >= C.  A thread takes one pixel and one chunk
// of channels: a load from each channel plane, coalesced across the warp's
// neighbouring pixels, and one 16-byte store (an odd number of 16-byte
// units apart: no bank conflicts).
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int sp, const T* xt,
                                           int C, int H, int W, int y0,
                                           int x0, int SH, int SW) {
  constexpr int CH = chunk<T>();
  const int npx = SH * SW, items = npx * (pad_chunk<T>(C) / CH);
  const size_t plane = (size_t)H * W;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int cc = i / npx, p = i - cc * npx;
    const int r = p / SW, q = p - r * SW;
    const int gy = y0 + r, gx = x0 + q;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* s = xt + (size_t)cc * CH * plane + (in ? (size_t)gy * W + gx : 0);
    // The chunk as four 32-bit words of raw bits: two bfloat16 or one
    // float32 each (zero bits are zero in both).
    uint32_t v[4];
    if constexpr (sizeof(T) == 2) {
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = cc * CH + 2 * e;
        const uint32_t lo = (in && c < C) ? s16[(size_t)(2 * e) * plane] : 0u;
        const uint32_t hi =
            (in && c + 1 < C) ? s16[(size_t)(2 * e + 1) * plane] : 0u;
        v[e] = lo | (hi << 16);
      }
    } else {
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (in && cc * CH + e < C) ? s32[(size_t)e * plane] : 0u;
    }
    const uint4 pack = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(dst + (size_t)p * sp + cc * CH) = pack;
  }
}

// One conv over the pixel-major tile src (row length sp; Kc =
// pad_chunk(Cin) channels read).  Output pixel p < M reads tile rows
// base(p) + off(tap), off(ky * ksz + kx) = ky * sw + kx.  wg: the packed
// weights [taps][Np][KP] in device memory; wbuf: weight_smem(taps, Np, KP)
// bytes of shared memory.  Calls epi(p, co, v0, v1) with the float32 sums
// of channels co and co + 1 (co even, co + 1 < Np) for every p < M.  Starts
// with __syncthreads(), so the caller's staging is complete and wbuf is
// free; the caller synchronises before it reads what epi wrote.
template <typename T, int NTW, int WN, int MFW, typename Base, typename Epi>
__device__ __forceinline__ void conv_tile(const T* src, int sp, int Kc,
                                          const T* __restrict__ wg, T* wbuf,
                                          int ksz, int sw, int Np, int KP,
                                          int M, Base base, Epi epi) {
  constexpr int WM = kWarps / WN;
  constexpr int CH = chunk<T>();  // K of a half step; a full step is 2 CH
  using Full = Step<T, true>;
  using Half = Step<T, false>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int taps = ksz * ksz;
  const int panel = Np * KP;
  const bool whole = resident<T>(taps, Np, KP);
  const int frags = (M + 15) / 16;
  const int per_pass = WM * MFW;
  const int passes = (frags + per_pass - 1) / per_pass;
  const int steps = passes * taps;
  const int kfull = Kc / (2 * CH) * (2 * CH);  // Kc - kfull is 0 or CH

  // B lane addresses: x4 loads n8 tiles j, j+1 at k, k + CH; x2/x1 (the
  // half step) loads tiles j, j+1 / j at one k.
  const int nt0 = wn * NTW;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * CH;
  const int bh_row = (lane & 7) + (((lane >> 3) & 1) << 3);

  __syncthreads();
  load_async(wbuf, wg, whole ? taps * panel : panel);
  if (whole) {
    wait_async();
    __syncthreads();
  }
  for (int pass = 0; pass < passes; ++pass) {
    int a_off[MFW];
    bool live[MFW];
#pragma unroll
    for (int i = 0; i < MFW; ++i) {
      const int f = pass * per_pass + wm * MFW + i;
      live[i] = f < frags;
      const int p = min(f * 16 + (lane & 15), M - 1);
      a_off[i] = base(p) * sp + (lane >> 4) * CH;
    }
    float acc[MFW][NTW][4];
#pragma unroll
    for (int i = 0; i < MFW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int tap = 0; tap < taps; ++tap) {
      const T* wp;
      if (whole) {
        wp = wbuf + tap * panel;
      } else {
        const int s = pass * taps + tap;
        wait_async();
        __syncthreads();  // panel s is in; every warp is done with s - 1
        if (s + 1 < steps)
          load_async(wbuf + ((s + 1) & 1) * panel,
                     wg + (size_t)((s + 1) % taps) * panel, panel);
        wp = wbuf + (s & 1) * panel;
      }
      const int ky = tap / ksz;
      const T* xs = src + (ky * sw + tap - ky * ksz) * sp;
      for (int k = 0; k < kfull; k += 2 * CH) {
        typename Full::A a[MFW];
#pragma unroll
        for (int i = 0; i < MFW; ++i) {
          if (!live[i]) continue;
          uint32_t r[4];
          ldsm_x4(r, xs + a_off[i] + k);
          Full::load_a(a[i], r);
        }
#pragma unroll
        for (int j = 0; j < NTW; j += 2) {
          uint32_t r[4];
          if (j + 1 < NTW)
            ldsm_x4(r, wp + ((nt0 + j) * 8 + b_row) * KP + k + b_k);
          else
            ldsm_x2(r, wp + ((nt0 + j) * 8 + (lane & 7)) * KP + k + b_k);
          typename Full::B b0, b1;
          Full::load_b(b0, r);
          if (j + 1 < NTW) Full::load_b(b1, r + 2);
#pragma unroll
          for (int i = 0; i < MFW; ++i) {
            if (!live[i]) continue;
            Full::mma(acc[i][j], a[i], b0);
            if (j + 1 < NTW) Full::mma(acc[i][j + 1], a[i], b1);
          }
        }
      }
      if (kfull < Kc) {  // the half step
        typename Half::A a[MFW];
#pragma unroll
        for (int i = 0; i < MFW; ++i) {
          if (!live[i]) continue;
          uint32_t r[2];
          ldsm_x2(r, xs + a_off[i] - (lane >> 4) * CH + kfull);
          Half::load_a(a[i], r);
        }
#pragma unroll
        for (int j = 0; j < NTW; j += 2) {
          uint32_t r[2];
          if (j + 1 < NTW)
            ldsm_x2(r, wp + ((nt0 + j) * 8 + bh_row) * KP + kfull);
          else
            ldsm_x1(r[0], wp + ((nt0 + j) * 8 + (lane & 7)) * KP + kfull);
          typename Half::B b0, b1;
          Half::load_b(b0, r);
          if (j + 1 < NTW) Half::load_b(b1, r + 1);
#pragma unroll
          for (int i = 0; i < MFW; ++i) {
            if (!live[i]) continue;
            Half::mma(acc[i][j], a[i], b0);
            if (j + 1 < NTW) Half::mma(acc[i][j + 1], a[i], b1);
          }
        }
      }
    }
    // Sums c0, c1 at (pixel g, channels 2t, 2t + 1); c2, c3 at pixel g + 8.
    const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MFW; ++i) {
      if (!live[i]) continue;
      const int p0 = (pass * per_pass + wm * MFW + i) * 16 + g;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int co = (nt0 + j) * 8 + t2;
        if (p0 < M) epi(p0, co, acc[i][j][0], acc[i][j][1]);
        if (p0 + 8 < M) epi(p0 + 8, co, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// The warp layout of Np output-channel rows: NT = Np / 8 n8 tiles on one
// warp column (WN = 1) for NT <= 7, else Np = 16 * ceil(NT / 2) on two
// (ops/chw.py, mma_layout mirrors this).  Calls f(NTW, WN) with both as
// std::integral_constant; cudaErrorInvalidValue for any other Np.
template <typename F>
int dispatch_np(int Np, F&& f) {
  using std::integral_constant;
#define SHIFTNET_NP(NP, NTW, WN) \
  case NP:                       \
    return f(integral_constant<int, NTW>{}, integral_constant<int, WN>{});
  switch (Np) {
    SHIFTNET_NP(8, 1, 1)
    SHIFTNET_NP(16, 2, 1)
    SHIFTNET_NP(24, 3, 1)
    SHIFTNET_NP(32, 4, 1)
    SHIFTNET_NP(40, 5, 1)
    SHIFTNET_NP(48, 6, 1)
    SHIFTNET_NP(56, 7, 1)
    SHIFTNET_NP(64, 4, 2)
    SHIFTNET_NP(80, 5, 2)
    SHIFTNET_NP(96, 6, 2)
    SHIFTNET_NP(112, 7, 2)
  }
#undef SHIFTNET_NP
  return (int)cudaErrorInvalidValue;
}

}  // namespace core
}  // namespace shiftnet
