// The implicit-GEMM conv core of cab_front and conv: a K x K convolution of
// a tile held in shared memory, on the tensor cores, with float32 sums.
// bfloat16 operands run mma.sync m16n8k16 (and m16n8k8); float32 operands
// run 3xTF32: each operand split into a TF32 high part and a TF32 low part
// (the rounding error of the high part), and a_lo b_hi + a_hi b_lo + a_hi
// b_hi summed on m16n8k8 (and m16n8k4) TF32 products, which keeps float32's
// accuracy where one TF32 product keeps about three decimal digits.  It is
// a device building block, not a kernel: cab_front.cu, conv.cu,
// conv_cat.cu, naf_gate.cu and naf_rep.cu stage their tiles and call
// conv_tile (and naf_rep.cu's grouped 5x5, group_tile); naf_back.cu and
// up_skip.cu run their 1x1 products on channel-major tiles with cm_tile.
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

// Phase timing of a kernel's blocks, compiled only with -DSHIFTNET_PHASES
// (tools/phase_naf.py builds such a library): SHIFTNET_PHASE(k) waits for
// the block, then thread 0 adds the clock64() cycles since the previous
// mark to the translation unit's phase_cycles[k].  Empty otherwise.
#ifdef SHIFTNET_PHASES
static __device__ unsigned long long phase_cycles[16];
#define SHIFTNET_PHASE_START unsigned long long phase_t0_ = clock64()
#define SHIFTNET_PHASE(k)                                           \
  do {                                                              \
    __syncthreads();                                                \
    if (threadIdx.x == 0) {                                         \
      const unsigned long long now_ = clock64();                    \
      atomicAdd(&::shiftnet::core::phase_cycles[k], now_ - phase_t0_); \
      phase_t0_ = now_;                                             \
    }                                                               \
  } while (0)
// Copy out and clear this translation unit's phase_cycles (host).
inline int read_phase_cycles(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#else
#define SHIFTNET_PHASE_START
#define SHIFTNET_PHASE(k)
#endif

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

// Shared-memory bytes of a conv's weights: whole, or two tap panels.  A
// 1x1 conv (one tap) is always whole: streaming would double-buffer the
// same panel.
template <typename T>
__host__ __device__ inline bool resident(int taps, int Np, int KP) {
  return taps == 1 ||
         (size_t)taps * Np * KP * sizeof(T) <= (size_t)kResidentBytes;
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

// The same loads with .trans: lane (g, t) receives elements (2t, g) and
// (2t + 1, g) of each stored 8 x 8 matrix, so a channel-major tile (rows of
// 8 pixels of one channel) gives the A fragment of a pixel-major one.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// Every commit group but the newest complete.
__device__ __forceinline__ void wait_async_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes from global to shared memory, asynchronously; zeros where !in
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Row length (elements) of a channel-major tile of m pixels (cm_tile): m
// rounded up to 16 (a fragment's pixels) plus 8, so a row is 16 bytes times
// an odd number in bfloat16 and 8 words off a multiple of 32 banks in
// float32.
__host__ __device__ constexpr int cm_pitch(int m) {
  return (m + 15) / 16 * 16 + 8;
}

// Channel planes c < C of one frame (plane elements each), pixels p0 .. p0
// + P - 1, into dst[c * xp + k], zero from the plane's end on.  aligned
// (the planes and p0 on the 16-byte grid, P a multiple of chunk<T>(), at
// most blockDim.x chunks): 16-byte cp.async copies, a thread at one chunk
// of every row it takes, in flight until the caller waits (no commit
// here); else element loads, done on return.
template <typename T>
__device__ __forceinline__ void load_planes(T* dst, int xp, const T* src,
                                            int C, long long plane,
                                            long long p0, int P,
                                            bool aligned) {
  constexpr int CH = chunk<T>();
  if (aligned) {
    const int tid = threadIdx.x, q = P / CH;
    const int step = blockDim.x / q;  // threads from step * q on idle
    const int k = (tid % q) * CH;
    const bool in = p0 + k < plane;
    for (int c = tid < step * q ? tid / q : C; c < C; c += step)
      cp_async16(dst + c * xp + k, in ? src + c * plane + p0 + k : src, in);
  } else {
    for (int i = threadIdx.x; i < C * P; i += blockDim.x) {
      const int c = i / P, k = i - c * P;
      dst[c * xp + k] =
          p0 + k < plane ? src[c * plane + p0 + k] : from_f<T>(0.f);
    }
  }
}

// The reverse: src[c * xp + k] to the planes' pixels p0 + k < plane, 16
// bytes a store where aligned.
template <typename T>
__device__ __forceinline__ void store_planes(T* dst, const T* src, int xp,
                                             int C, long long plane,
                                             long long p0, int P,
                                             bool aligned) {
  constexpr int CH = chunk<T>();
  if (aligned) {
    const int tid = threadIdx.x, q = P / CH;
    const int step = blockDim.x / q, k = (tid % q) * CH;
    if (p0 + k < plane)
      for (int c = tid < step * q ? tid / q : C; c < C; c += step)
        *reinterpret_cast<uint4*>(dst + c * plane + p0 + k) =
            *reinterpret_cast<const uint4*>(src + c * xp + k);
  } else {
    for (int i = threadIdx.x; i < C * P; i += blockDim.x) {
      const int c = i / P, k = i - c * P;
      if (p0 + k < plane) dst[c * plane + p0 + k] = src[c * xp + k];
    }
  }
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

// stage_tile with kBatch items' loads issued before their stores, so that
// their latencies overlap (the naf kernels' tiles), and an optional
// per-channel scale (in T): each staged value is then x * scale[c], a
// product in T.
template <typename T, int kBatch>
__device__ __forceinline__ void stage_tile_batched(
    T* dst, int sp, const T* xt, int C, int H, int W, int y0, int x0, int SH,
    int SW, const T* scale = nullptr) {
  constexpr int CH = chunk<T>();
  const int npx = SH * SW, items = npx * (pad_chunk<T>(C) / CH);
  const size_t plane = (size_t)H * W;
  for (int i0 = threadIdx.x; i0 < items; i0 += blockDim.x * kBatch) {
    // Each chunk as four 32-bit words of raw bits: two bfloat16 or one
    // float32 each (zero bits are zero in both).
    uint4 pack[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int cc = i / npx, p = i - cc * npx;
      const int r = p / SW, q = p - r * SW;
      const int gy = y0 + r, gx = x0 + q;
      const bool in =
          i < items && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* s =
          xt + (in ? (size_t)cc * CH * plane + (size_t)gy * W + gx : 0);
      uint32_t v[4];
      if constexpr (sizeof(T) == 2) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(s);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cc * CH + 2 * e;
          const uint32_t lo =
              (in && c < C) ? s16[(size_t)(2 * e) * plane] : 0u;
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
      pack[b] = make_uint4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i >= items) break;
      const int cc = i / npx, p = i - cc * npx;
      if (scale) {
        T* e = reinterpret_cast<T*>(&pack[b]);
#pragma unroll
        for (int k = 0; k < CH; ++k)
          if (cc * CH + k < C)
            e[k] = from_f<T>(to_f(e[k]) * to_f(scale[cc * CH + k]));
      }
      *reinterpret_cast<uint4*>(dst + (size_t)p * sp + cc * CH) = pack[b];
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void load2(const bf16* p, float& v0, float& v1) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v0 = v.x;
  v1 = v.y;
}
__device__ __forceinline__ void load2(const float* p, float& v0, float& v1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  v0 = v.x;
  v1 = v.y;
}

// Write a block's channel-major output tile sbuf[c * sbp + r * TW + q]
// (zero outside the image) to frame ot, 16-byte stores where the rows and
// tile columns lie on the 16-byte grid.
template <typename T>
__device__ __forceinline__ void store_tile(const T* sbuf, int sbp, T* ot,
                                           int C, int H, int W, int y0,
                                           int x0, int TH, int TW) {
  constexpr int CH = chunk<T>();
  const size_t plane = (size_t)H * W;
  if (W % CH == 0 && TW % CH == 0) {
    const int qv = TW / CH, items = C * TH * qv;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int c = i / (TH * qv), rem = i - c * TH * qv;
      const int r = rem / qv, q = (rem - r * qv) * CH;
      if (y0 + r < H && x0 + q < W)
        *reinterpret_cast<uint4*>(ot + c * plane + (size_t)(y0 + r) * W +
                                  x0 + q) =
            *reinterpret_cast<const uint4*>(sbuf + c * sbp + r * TW + q);
    }
  } else {
    for (int i = threadIdx.x; i < C * TH * TW; i += blockDim.x) {
      const int c = i / (TH * TW), p = i - c * TH * TW;
      const int r = p / TW, q = p - r * TW;
      if (y0 + r < H && x0 + q < W)
        ot[c * plane + (size_t)(y0 + r) * W + x0 + q] = sbuf[c * sbp + p];
    }
  }
}

// store_tile, then the tile's per-channel sums, in a fixed order (one warp
// per channel, no atomics), to sums_row[c].
template <typename T>
__device__ __forceinline__ void store_tile_and_sums(const T* sbuf, int sbp,
                                                    T* ot, int C, int H,
                                                    int W, int y0, int x0,
                                                    int TH, int TW,
                                                    float* sums_row) {
  store_tile(sbuf, sbp, ot, C, H, W, y0, x0, TH, TW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += blockDim.x >> 5) {
    float part = 0.f;
    for (int p = lane; p < TH * TW; p += 32) part += to_f(sbuf[c * sbp + p]);
    part = warp_sum(part);
    if (lane == 0) sums_row[c] = part;
  }
}

// Per-frame channel sums of a persistent block's tiles (the naf kernels):
// thread c < C owns channel c, adds each tile's plane in order, 16 bytes at
// a time, and writes the frame's sum to row (t, blockIdx.x) of a [T][rows]
// [C] buffer (zeroed by the caller) when its jobs move on to the next
// frame; jobs come in increasing order, so each row is written once.  A
// fixed order and no atomics: the sums are deterministic.
template <typename T>
struct FrameSums {
  float* sums;
  int rows, C, t = -1;
  float acc = 0.f;
  __device__ FrameSums(float* s, int r, int c) : sums(s), rows(r), C(c) {}
  __device__ void flush() {
    if (t >= 0 && (int)threadIdx.x < C)
      sums[((size_t)t * rows + blockIdx.x) * C + threadIdx.x] = acc;
  }
  // Add the tile sbuf[c * sbp + p], p < n_px (a multiple of chunk<T>()).
  __device__ void add(int frame, const T* sbuf, int sbp, int n_px) {
    if (frame != t) {
      flush();
      t = frame;
      acc = 0.f;
    }
    const int c = threadIdx.x;
    if (c >= C) return;
    for (int p = 0; p < n_px; p += chunk<T>()) {
      const uint4 pack = *reinterpret_cast<const uint4*>(sbuf + c * sbp + p);
      const T* v = reinterpret_cast<const T*>(&pack);
#pragma unroll
      for (int k = 0; k < chunk<T>(); ++k) acc += to_f(v[k]);
    }
  }
};

// One conv over the pixel-major tile src (row length sp; Kc =
// pad_chunk(Cin) channels read).  Output pixel p < M reads tile rows
// base(p) + off(tap), off(ky * ksz + kx) = ky * sw + kx.  wg: the packed
// weights [taps][Np][KP] in device memory; wbuf: weight_smem(taps, Np, KP)
// bytes of shared memory; with kLoaded, wbuf already holds the whole
// panels, whatever their size (a persistent block's, loaded once; wg
// unused).  Calls epi(p, co, v0, v1) with the float32 sums of channels co
// and co + 1 (co even, co + 1 < Np) for every p < M.  With
// kPair, the packed rows come in pairs of n8 tiles (tile 2b holds a gate's
// first factors, tile 2b + 1 their partners: ops/naf_chw.py, gate_rows) and
// epi(p, o, a0, a1, b0, b1) takes both tiles' sums at once, o = 8 b + the
// lane's channel pair.  Starts with __syncthreads(), so the caller's
// staging is complete and wbuf is free; the caller synchronises before it
// reads what epi wrote.
template <typename T, int NTW, int WN, int MFW, bool kPair = false,
          bool kLoaded = false, typename Base, typename Epi>
__device__ __forceinline__ void conv_tile(const T* src, int sp, int Kc,
                                          const T* __restrict__ wg, T* wbuf,
                                          int ksz, int sw, int Np, int KP,
                                          int M, Base base, Epi epi) {
  static_assert(!kPair || NTW % 2 == 0, "gate pairs of n8 tiles");
  constexpr int WM = kWarps / WN;
  constexpr int CH = chunk<T>();  // K of a half step; a full step is 2 CH
  using Full = Step<T, true>;
  using Half = Step<T, false>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int taps = ksz * ksz;
  const int panel = Np * KP;
  const bool whole = kLoaded || resident<T>(taps, Np, KP);
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

  if constexpr (kLoaded) {  // the caller's panels, loaded or in flight
    wait_async();
    __syncthreads();
  } else {
    __syncthreads();
    load_async(wbuf, wg, whole ? taps * panel : panel);
    if (whole) {
      wait_async();
      __syncthreads();
    }
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
      if constexpr (kPair) {
#pragma unroll
        for (int j = 0; j < NTW; j += 2) {
          const int o = (nt0 + j) / 2 * 8 + t2;
          if (p0 < M)
            epi(p0, o, acc[i][j][0], acc[i][j][1], acc[i][j + 1][0],
                acc[i][j + 1][1]);
          if (p0 + 8 < M)
            epi(p0 + 8, o, acc[i][j][2], acc[i][j][3], acc[i][j + 1][2],
                acc[i][j + 1][3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int co = (nt0 + j) * 8 + t2;
          if (p0 < M) epi(p0, co, acc[i][j][0], acc[i][j][1]);
          if (p0 + 8 < M) epi(p0 + 8, co, acc[i][j][2], acc[i][j][3]);
        }
      }
    }
  }
}

// A grouped conv of groups of 8 input and 8 output channels (RepConv's G =
// 8): group grp reads channels 8 grp .. 8 grp + 7 of the pixel-major tile
// src, which is one K step of the tensor cores (one 16-byte chunk, k8, in
// bfloat16; two chunks, a TF32 k8 in float32), and writes one n8 tile.  wg:
// the packed panels [groups][taps][8][mma_pitch(8)] (ops/naf_chw.py,
// pack_groups), all kept in wbuf (with kLoaded: already there).  A warp
// takes MFW m16 fragments of one group at a time, the B fragment of a tap
// shared by them.  Calls epi(p, co, v0, v1) as conv_tile does; starts with
// __syncthreads().
template <typename T, int MFW, bool kLoaded = false, typename Base,
          typename Epi>
__device__ __forceinline__ void group_tile(const T* src, int sp, int groups,
                                           const T* __restrict__ wg, T* wbuf,
                                           int ksz, int sw, int M, Base base,
                                           Epi epi) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int CH = chunk<T>();
  using S = Step<T, kF32>;  // K = 8: a full step in TF32, half in bf16
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int taps = ksz * ksz;
  const int kp = mma_pitch<T>(8), panel = 8 * kp;
  const int frags = (M + 15) / 16;
  const int fsets = (frags + MFW - 1) / MFW;

  if constexpr (!kLoaded) {
    __syncthreads();
    load_async(wbuf, wg, groups * taps * panel);
  }
  wait_async();
  __syncthreads();
  for (int item = warp; item < groups * fsets; item += kWarps) {
    const int grp = item / fsets, fs = item - grp * fsets;
    int a_off[MFW];
    bool live[MFW];
#pragma unroll
    for (int i = 0; i < MFW; ++i) {
      const int f = fs * MFW + i;
      live[i] = f < frags;
      const int p = min(f * 16 + (lane & 15), M - 1);
      a_off[i] = base(p) * sp + 8 * grp + (kF32 ? (lane >> 4) * CH : 0);
    }
    float acc[MFW][4];
#pragma unroll
    for (int i = 0; i < MFW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
    const T* wgp = wbuf + grp * taps * panel;
    for (int tap = 0; tap < taps; ++tap) {
      const int ky = tap / ksz;
      const T* xs = src + (ky * sw + tap - ky * ksz) * sp;
      const T* wp = wgp + tap * panel + (lane & 7) * kp;
      typename S::B b;
      uint32_t rb[2];
      if constexpr (kF32)
        ldsm_x2(rb, wp + ((lane >> 3) & 1) * CH);
      else
        ldsm_x1(rb[0], wp);
      S::load_b(b, rb);
#pragma unroll
      for (int i = 0; i < MFW; ++i) {
        if (!live[i]) continue;
        typename S::A a;
        uint32_t ra[4];
        if constexpr (kF32)
          ldsm_x4(ra, xs + a_off[i]);
        else
          ldsm_x2(ra, xs + a_off[i]);
        S::load_a(a, ra);
        S::mma(acc[i], a, b);
      }
    }
    const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MFW; ++i) {
      if (!live[i]) continue;
      const int p0 = (fs * MFW + i) * 16 + g;
      if (p0 < M) epi(p0, 8 * grp + t2, acc[i][0], acc[i][1]);
      if (p0 + 8 < M) epi(p0 + 8, 8 * grp + t2, acc[i][2], acc[i][3]);
    }
  }
}

// A values times a per-channel scale, each product rounded to T as the
// reference's s * ca is (a bfloat16 product is exact in float32, so one
// rounding either way): the two bfloat16 of v by s[0], s[1].
__device__ __forceinline__ uint32_t scale2(uint32_t v, const bf16* s) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(s));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The first of the output channel pair that cm_tile hands its epilogue for
// the warp's j-th n8 tile: fixed per thread, so an epilogue can keep
// per-channel terms in registers.
template <int NTW, int WN>
__device__ __forceinline__ int cm_channel(int j) {
  const int wn = (threadIdx.x >> 5) / (kWarps / WN);
  return ((wn * NTW + j) << 3) + 2 * (threadIdx.x & 3);
}

// A 1x1 conv of a channel-major tile on the tensor cores (naf_back,
// up_skip): acc[p][co] = sum over k < Kc of src[k * xp + p] * W[co][k] for
// pixels p < M, W the one-tap panel [Np][KP] already in shared memory
// (wbuf, pack_taps' layout).  The A operand is read as it is stored,
// channel rows of pixels, so tiles come from NCHW planes by plain 16-byte
// copies: ldmatrix.trans in bfloat16 (8 channel rows of 8 pixels), 32-bit
// loads in float32; xp = cm_pitch(M) keeps both conflict-free.  Pixels up
// to M rounded to 16 are read and their sums dropped; rows k < Kc must
// hold numbers (the caller zeroes rows Cin .. Kc - 1).  With kScale, each
// A value is first multiplied by scale[k] (Kc values in T, shared memory),
// the product rounded to T.  A warp takes MFW m16 fragments at a time and
// NTW n8 tiles.  Calls epi(p, j, co, v0, v1) with the float32 sums of
// channels co = cm_channel<NTW, WN>(j) and co + 1 at pixel p.  No barrier:
// the caller synchronises before (src, wbuf, scale written) and after
// (before it reads what epi wrote).
template <typename T, int NTW, int WN, int MFW, bool kScale, typename Epi>
__device__ __forceinline__ void cm_tile(const T* src, int xp, int Kc,
                                        const T* wbuf, int KP, int M,
                                        const T* scale, Epi epi) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int WM = kWarps / WN;
  constexpr int CH = chunk<T>();
  using Full = Step<T, true>;
  using Half = Step<T, false>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t4 = lane & 3;
  const int frags = (M + 15) / 16;
  const int kfull = Kc / (2 * CH) * (2 * CH);  // Kc - kfull is 0 or CH
  const int nt0 = wn * NTW;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * CH;
  const int bh_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  // bfloat16 A rows: matrices (pixels 0-7, 8-15) x (channels k .. k + 7,
  // k + 8 .. k + 15), lanes 8 j .. 8 j + 7 addressing matrix j's rows
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_m = ((lane >> 3) & 1) << 3;

  for (int f0 = wm * MFW; f0 < frags; f0 += WM * MFW) {
    bool live[MFW];
#pragma unroll
    for (int i = 0; i < MFW; ++i) live[i] = f0 + i < frags;
    float acc[MFW][NTW][4];
#pragma unroll
    for (int i = 0; i < MFW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int k = 0; k < kfull; k += 2 * CH) {
      typename Full::A a[MFW];
#pragma unroll
      for (int i = 0; i < MFW; ++i) {
        if (!live[i]) continue;
        const int m0 = (f0 + i) * 16;
        uint32_t r[4];
        if constexpr (kF32) {
          const float* c0 = src + (size_t)(k + t4) * xp + m0 + g;
          const float* c1 = c0 + (size_t)4 * xp;
          float v[4] = {c0[0], c0[8], c1[0], c1[8]};
          if constexpr (kScale) {
            v[0] *= scale[k + t4];
            v[1] *= scale[k + t4];
            v[2] *= scale[k + t4 + 4];
            v[3] *= scale[k + t4 + 4];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e] = __float_as_uint(v[e]);
        } else {
          ldsm_x4_t(r, src + (size_t)(k + a_k) * xp + m0 + a_m);
          if constexpr (kScale) {
            r[0] = scale2(r[0], scale + k + 2 * t4);
            r[1] = scale2(r[1], scale + k + 2 * t4);
            r[2] = scale2(r[2], scale + k + 8 + 2 * t4);
            r[3] = scale2(r[3], scale + k + 8 + 2 * t4);
          }
        }
        Full::load_a(a[i], r);
      }
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        uint32_t r[4];
        if (j + 1 < NTW)
          ldsm_x4(r, wbuf + ((nt0 + j) * 8 + b_row) * KP + k + b_k);
        else
          ldsm_x2(r, wbuf + ((nt0 + j) * 8 + (lane & 7)) * KP + k + b_k);
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
    if (kfull < Kc) {  // the half step: k8 in bfloat16, k4 in float32
      typename Half::A a[MFW];
#pragma unroll
      for (int i = 0; i < MFW; ++i) {
        if (!live[i]) continue;
        const int m0 = (f0 + i) * 16;
        uint32_t r[2];
        if constexpr (kF32) {
          const float* c0 = src + (size_t)(kfull + t4) * xp + m0 + g;
          float v[2] = {c0[0], c0[8]};
          if constexpr (kScale) {
            v[0] *= scale[kfull + t4];
            v[1] *= scale[kfull + t4];
          }
          r[0] = __float_as_uint(v[0]);
          r[1] = __float_as_uint(v[1]);
        } else {
          ldsm_x2_t(r, src + (size_t)(kfull + (lane & 7)) * xp + m0 + a_m);
          if constexpr (kScale) {
            r[0] = scale2(r[0], scale + kfull + 2 * t4);
            r[1] = scale2(r[1], scale + kfull + 2 * t4);
          }
        }
        Half::load_a(a[i], r);
      }
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        uint32_t r[2];
        if (j + 1 < NTW)
          ldsm_x2(r, wbuf + ((nt0 + j) * 8 + bh_row) * KP + kfull);
        else
          ldsm_x1(r[0], wbuf + ((nt0 + j) * 8 + (lane & 7)) * KP + kfull);
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
    // Sums c0, c1 at (pixel g, channels 2t, 2t + 1); c2, c3 at pixel g + 8.
#pragma unroll
    for (int i = 0; i < MFW; ++i) {
      if (!live[i]) continue;
      const int p0 = (f0 + i) * 16 + g;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int co = cm_channel<NTW, WN>(j);
        if (p0 < M) epi(p0, j, co, acc[i][j][0], acc[i][j][1]);
        if (p0 + 8 < M) epi(p0 + 8, j, co, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// Threads of a depthwise pass: thread i takes channel pair i % npair at
// every (blockDim.x / npair)-th item from item i / npair, so its weights
// are loaded once a tile and a warp's loads are contiguous.
struct PairSlots {
  int pair, slot, slots;
  __device__ PairSlots(int npair)
      : pair(threadIdx.x % npair),
        slot(threadIdx.x / npair),
        slots(blockDim.x / npair) {}
  __device__ bool idle() const { return slot >= slots; }
};

// Persistent blocks: as many as the card holds at once, at most max_rows
// (the rows of the caller's sums buffer), and at most one a job.
template <typename K>
inline int persistent_grid(K kern, size_t smem, int jobs, int max_rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                kThreads, smem);
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > max_rows) blocks = max_rows;
  return jobs < blocks ? jobs : blocks;
}

// The warp layout of Np output-channel rows: NT = Np / 8 n8 tiles on one
// warp column (WN = 1) for NT <= 7, else Np = 16 * ceil(NT / 2) on two
// (ops/chw.py, mma_layout mirrors this).  kExpand: the layouts of the
// naf_gate / naf_rep expands n -> 2n (n = 32, 48, 64, 80), two warp
// columns of an even number of tiles each, so that a gate pair of tiles
// sits in one warp.  Calls f(NTW, WN) with both as
// std::integral_constant; cudaErrorInvalidValue for any other Np.
template <bool kExpand = false, typename F>
int dispatch_np(int Np, F&& f) {
  using std::integral_constant;
#define SHIFTNET_NP(NP, NTW, WN) \
  case NP:                       \
    return f(integral_constant<int, NTW>{}, integral_constant<int, WN>{});
  if constexpr (kExpand) {
    switch (Np) {
      SHIFTNET_NP(64, 4, 2)
      SHIFTNET_NP(96, 6, 2)
      SHIFTNET_NP(128, 8, 2)
      SHIFTNET_NP(160, 10, 2)
    }
  } else {
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
  }
#undef SHIFTNET_NP
  return (int)cudaErrorInvalidValue;
}

}  // namespace core
}  // namespace shiftnet
