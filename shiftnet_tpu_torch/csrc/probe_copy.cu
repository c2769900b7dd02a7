// Probes block_copy and block_copy_staged: a list of pieces copied between
// two bf16 tensors, device memory to device memory (direct) or through
// shared memory (staged).  A piece is (src, dst, rows) in elements: `rows`
// rows of `lanes` elements, row i at src + i * src_ld and dst + i * dst_ld.
// The wrapper (ops/probes.py) computes the pieces from (frame, row) lists.
//
// Replaces, direct:
//   tools/probe_hbm_copy.py:29 _copy_kernel (HBM->HBM copy, dynamic source
//     frame),
//   tools/probe_copy_bw.py:45 _hbm_kernel (the half-channel permutation as
//     HBM->HBM copies),
//   tools/probe_dma_align.py:64 _slice_kernel (a row slice at an offset);
// staged:
//   tools/microbench.py:126 copy_kernel (2 * x[0] staged in row slabs),
//   tools/probe_copy_bw.py:61 _vmem_kernel (the permutation through VMEM in
//     lane tiles, 2 slots),
//   tools/probe_dma_align.py:34 _dma_off_kernel (a DMA from a row offset).
//
// What bounds them: device memory, each piece read once and written once,
// 4 bytes an element at 3.35 TB/s.
//
// Direct design.  One grid row per piece; threads walk the piece with
// neighbouring threads on neighbouring addresses, 16 bytes a thread when the
// source and destination rows are 16-byte aligned, 2 bytes a thread when not.
//
// Staged design.  One block per (piece, lane tile).  The tile is cut into
// chunks of whole rows (or row segments, for a tile wider than a slot) that
// fit a 16 KB slot; two slots, double buffered: cp.async (16 bytes, .cg)
// fills one while the block writes the other out.  cp.async needs 16-byte
// aligned addresses on both sides, so each row is fetched from its source
// address rounded down to 16 bytes, into a slot row with 16 bytes of slack,
// and read back from the slot at the source's offset within its 16-byte
// unit: any 2-byte source offset comes out exact.  A fetched unit that
// starts before or ends after the piece stays inside the allocation: it
// shares a 16-byte unit with an element of the piece, and allocations are
// 512-byte granular.  The write-out stores 16 bytes a thread on the
// destination's 16-byte grid (scalar at a misaligned head and at the tail),
// reading the slot as one 16-byte word when its offset is aligned too and
// as eight halfwords otherwise; `scale` != 1 multiplies in float32 and
// rounds to nearest even, as torch's bf16 multiply does.
#include <algorithm>

#include "common.cuh"

namespace shiftnet {

constexpr int kMaxPieces = 128;  // ops/probes.py, MAX_PIECES
constexpr int kCopyThreads = 256;
constexpr int kSlotBytes = 16384;
constexpr int kSegMax = 8176;  // lanes of a chunk: 2 * 8176 + 16 <= a slot

// (src, dst, rows) of each piece, in elements: a kernel parameter.
struct Pieces {
  long long v[3 * kMaxPieces];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__global__ void __launch_bounds__(kCopyThreads)
    block_copy_kernel(const uint16_t* __restrict__ x,
                      uint16_t* __restrict__ out, Pieces p, int lanes,
                      long long src_ld, long long dst_ld) {
  const int pi = blockIdx.y;
  const uint16_t* s = x + p.v[3 * pi];
  uint16_t* d = out + p.v[3 * pi + 1];
  const long long rows = p.v[3 * pi + 2];
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lanes % 8 == 0 && src_ld % 8 == 0 && dst_ld % 8 == 0 && aligned16(s) &&
      aligned16(d)) {
    const long long per_row = lanes / 8;
    for (long long i = i0; i < rows * per_row; i += step) {
      const long long r = i / per_row, c = (i - r * per_row) * 8;
      *reinterpret_cast<uint4*>(d + r * dst_ld + c) =
          *reinterpret_cast<const uint4*>(s + r * src_ld + c);
    }
  } else {
    for (long long i = i0; i < rows * lanes; i += step) {
      const long long r = i / lanes, c = i - r * lanes;
      d[r * dst_ld + c] = s[r * src_ld + c];
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint16_t scaled(uint16_t v, float scale) {
  if (scale == 1.f) return v;
  const float f = __bfloat162float(__ushort_as_bfloat16(v)) * scale;
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

// One chunk of a (piece, tile): rows [r0, r0 + nr), lanes [c0, c0 + len)
// of the tile.
struct Chunk {
  int r0, nr, c0, len;
};

__global__ void __launch_bounds__(kCopyThreads)
    block_copy_staged_kernel(const uint16_t* __restrict__ x,
                             uint16_t* __restrict__ out, Pieces p, int lanes,
                             long long src_ld, long long dst_ld, int tile,
                             float scale) {
  extern __shared__ __align__(16) unsigned char slots[];
  const int pi = blockIdx.y;
  const int l0 = blockIdx.x * tile;
  const int width = min(tile, lanes - l0);  // lanes of this tile
  const uint16_t* s = x + p.v[3 * pi] + l0;
  uint16_t* d = out + p.v[3 * pi + 1] + l0;
  const int rows = (int)p.v[3 * pi + 2];
  const int seg = min(width, kSegMax);
  const int nseg = (width + seg - 1) / seg;
  const int rs = (seg * 2 + 15) / 16 * 16 + 16;  // slot row, bytes
  const int rpc = nseg > 1 ? 1 : max(1, kSlotBytes / rs);
  const int n_chunks = (rows + rpc - 1) / rpc * nseg;

  auto chunk = [&](int q) {
    Chunk c;
    c.r0 = q / nseg * rpc;
    c.nr = min(rpc, rows - c.r0);
    c.c0 = q % nseg * seg;
    c.len = min(seg, width - c.c0);
    return c;
  };
  auto fetch = [&](int q) {
    const Chunk c = chunk(q);
    unsigned char* slot = slots + (q & 1) * kSlotBytes;
    const int units = rs / 16;
    for (int i = threadIdx.x; i < c.nr * units; i += blockDim.x) {
      const int rr = i / units, u = i - rr * units;
      const uintptr_t a =
          (uintptr_t)(s + (long long)(c.r0 + rr) * src_ld + c.c0);
      const uintptr_t a0 = a & ~(uintptr_t)15;
      if (a0 + 16 * u < a + 2 * c.len)
        cp_async16(slot + rr * rs + 16 * u,
                   reinterpret_cast<const void*>(a0 + 16 * u));
    }
  };
  auto write = [&](int q) {
    const Chunk c = chunk(q);
    const unsigned char* slot = slots + (q & 1) * kSlotBytes;
    for (int rr = 0; rr < c.nr; ++rr) {
      const long long r = c.r0 + rr;
      const int head = (int)((uintptr_t)(s + r * src_ld + c.c0) & 15);
      const unsigned char* row = slot + rr * rs + head;
      uint16_t* dr = d + r * dst_ld + c.c0;
      const int mis = (int)(((uintptr_t)dr & 15) / 2);
      const int n_head = min(c.len, (8 - mis) % 8);
      const int nv = (c.len - n_head) / 8;
      const int n_items = c.len - 7 * nv;  // scalars + vectors
      for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
        if (i >= n_head && i < n_head + nv) {
          const int e = n_head + (i - n_head) * 8;
          union {
            uint4 q;
            uint16_t h[8];
          } v;
          if (((head + 2 * e) & 15) == 0) {
            v.q = *reinterpret_cast<const uint4*>(row + 2 * e);
          } else {
            const uint16_t* sv = reinterpret_cast<const uint16_t*>(row) + e;
#pragma unroll
            for (int j = 0; j < 8; ++j) v.h[j] = sv[j];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) v.h[j] = scaled(v.h[j], scale);
          *reinterpret_cast<uint4*>(dr + e) = v.q;
        } else {
          const int e = i < n_head ? i : i + 7 * nv;
          dr[e] = scaled(reinterpret_cast<const uint16_t*>(row)[e], scale);
        }
      }
    }
  };

  fetch(0);
  cp_async_commit();
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) fetch(q + 1);
    cp_async_commit();
    cp_async_wait1();  // chunk q has landed (this thread's part)
    __syncthreads();   // ... and every thread's
    write(q);
    __syncthreads();   // slot q & 1 is free for chunk q + 2
  }
}

static int copy_pieces(const long long* table, int n_pieces, Pieces* p) {
  if (n_pieces < 1 || n_pieces > kMaxPieces) return 0;
  for (int i = 0; i < 3 * n_pieces; ++i) p->v[i] = table[i];
  return 1;
}

}  // namespace shiftnet

// x, out: bf16; table: n_pieces x (src, dst, rows) in elements.
extern "C" int shiftnet_block_copy(const void* x, void* out,
                                   const long long* table, int n_pieces,
                                   int lanes, long long src_ld,
                                   long long dst_ld, void* stream) {
  using namespace shiftnet;
  Pieces p;
  if (!copy_pieces(table, n_pieces, &p)) return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int i = 0; i < n_pieces; ++i)
    most = std::max(most, table[3 * i + 2] * lanes);
  const long long per_block = (long long)kCopyThreads * 8 * 4;
  long long blocks = (most + per_block - 1) / per_block;
  blocks = std::max(1LL, std::min(blocks, 65535LL));
  block_copy_kernel<<<dim3((unsigned)blocks, n_pieces), kCopyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), p, lanes,
      src_ld, dst_ld);
  return (int)cudaGetLastError();
}

// As shiftnet_block_copy, through shared memory, one block per (piece,
// lane tile of `tile` lanes), times `scale`.
extern "C" int shiftnet_block_copy_staged(const void* x, void* out,
                                          const long long* table,
                                          int n_pieces, int lanes,
                                          long long src_ld, long long dst_ld,
                                          int tile, float scale,
                                          void* stream) {
  using namespace shiftnet;
  Pieces p;
  if (!copy_pieces(table, n_pieces, &p) || tile < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (lanes + tile - 1) / tile;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  block_copy_staged_kernel<<<dim3(n_tiles, n_pieces), kCopyThreads,
                             2 * kSlotBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), p, lanes,
      src_ld, dst_ld, tile, scale);
  return (int)cudaGetLastError();
}
