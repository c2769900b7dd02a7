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
// Direct design (block_copy_kernel).  One grid row per piece; a piece is
// rows x per_row units, 16 bytes each (8 lanes) where the wrapper's route
// is `vector` (every row of both sides on the 16-byte grid), else single
// elements.  Thread i of block b takes units (j * blocks + b) * threads +
// i, j < kPer, as one sweep of a grid-stride loop each, and issues all its
// loads before its first store, so it waits out one memory round trip, not
// one for each unit; rows come from a 32-bit division.  The wrapper sizes
// the grid from the units (ops/probes.py, copy_grid): one unit a thread
// where a wave of blocks holds the copy (the small probe copies, at the
// launch's latency: the batch is a template constant, so such a thread
// runs no loop), else kCopyUnroll units a thread on as many blocks as
// that takes.  (Two other grids ran the (12, 320, 72320) permutation
// slower than this one in tuning: a persistent wave of blocks
// striding over the pieces, and blocks that each copy one contiguous
// span.)  The piece table is a kernel parameter: 96 bytes for up to
// kFewPieces pieces, else the staged copies' 3 KB table (a 3 KB parameter
// costs a 40-row copy 0.02-0.26 us, tools/probe_launch.py).
//
// Staged design, on the TMA (block_copy_tma_kernel; tma.cuh).  The pieces
// are cut into boxes of box_rows x box_lanes elements (ops/probes.tma_plan,
// at most STAGE_BYTES); box b is found from the pieces' first boxes.  One
// thread a block issues the copies: cp.async.bulk.tensor loads a box from
// a 2-D map of the whole source, at element coordinates (any source row is
// exact), into a ring of `stages` shared-memory stages, each with a
// transaction-count mbarrier; when a box has landed, a TMA store writes it
// out and bulk groups free its stage.  With scale != 1 the block's warps
// wait on the stage's barrier and scale the box in shared memory (float32
// multiply, round to nearest even, as torch's bf16 multiply does), then
// fence.proxy.async and a block barrier order those writes before the TMA
// store reads them.  Blocks take one box each where one wave holds every
// box, else are persistent over the boxes.
//   A load's first lane must lie on the 16-byte grid: a box at a source
// lane 6 bytes past it stopped the kernel with an illegal instruction
// (NVIDIA H100, CUDA 12.8).  A source lane off the grid therefore loads
// from the lane rounded down, 8 lanes wider, and the warps shift each row
// by the `shift` lanes into a second box of the stage, which the store
// reads.
//   Clipping.  A store clips only at its map's own bounds, so each run of
// pieces of equal rows whose destinations are equally spaced has a 3-D
// map of its own, (lanes, rows, pieces of the run): a box that overhangs a
// piece's rows or lanes writes nothing past them.  Up to kParamMaps run
// maps travel in the kernel parameter; more are copied into device memory
// before the launch and acquired by the issuing thread before use.
//   Constraints of a map (the wrapper routes around them): the source and
// destination 16-byte aligned, the source and destination row lengths a
// multiple of 8 elements; a box of at most 256 x 256, its row a multiple
// of 16 bytes.  The wrapper's boxes take whole 128-byte lines where they
// are that wide, so no store leaves a 32-byte sector part written.
//
// Staged design, cp.async (block_copy_staged_kernel), for what a tensor map
// cannot describe (a row length not a multiple of 8 elements, a misaligned
// base).  One block per (piece, lane tile).  The tile is cut into
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
// as eight halfwords otherwise; `scale` != 1 multiplies as above.
#include <algorithm>
#include <vector>

#include "common.cuh"
#include "tma.cuh"

namespace shiftnet {

constexpr int kMaxPieces = 128;  // ops/probes.py, MAX_PIECES
constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;  // ops/probes.py, COPY_UNROLL
constexpr int kFewPieces = 4;   // FEW_PIECES
constexpr int kSlotBytes = 16384;
constexpr int kSegMax = 8176;  // lanes of a chunk: 2 * 8176 + 16 <= a slot

// (src, dst, rows) of up to kN pieces, in elements: a kernel parameter.
template <int kN>
struct PieceTable {
  long long v[3 * kN];
};
using Pieces = PieceTable<kMaxPieces>;
using FewPieces = PieceTable<kFewPieces>;

// U: the unit, uint4 (8 lanes) or uint16_t (one); rows of per_row units.
// kPer: units a thread, one batch.  kN: the pieces the table holds.
template <typename U, int kPer, int kN>
__global__ void __launch_bounds__(kCopyThreads)
    block_copy_kernel(const uint16_t* __restrict__ x,
                      uint16_t* __restrict__ out,
                      const __grid_constant__ PieceTable<kN> p,
                      uint32_t per_row, long long src_ld, long long dst_ld) {
  constexpr int kLanes = sizeof(U) / 2;
  // The first piece reads its fields straight from the parameter (the
  // shortest path to the first load of a one-piece copy); others index it
  // in place (__grid_constant__: without it, indexing copied the 96-byte
  // table to a stack frame, ptxas -v).
  const int pi = blockIdx.y;
  long long so = p.v[0], dso = p.v[1], rows = p.v[2];
  if (pi) {
    so = p.v[3 * pi];
    dso = p.v[3 * pi + 1];
    rows = p.v[3 * pi + 2];
  }
  const uint32_t units = (uint32_t)rows * per_row;  // < 2^31 (wrapper)
  const uint32_t sweep = gridDim.x * blockDim.x;
  const uint32_t u0 = blockIdx.x * blockDim.x + threadIdx.x;
  U v[kPer];
  long long d[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const uint32_t u = u0 + j * sweep;
    if (u < units) {
      const uint32_t r = u / per_row;
      const long long c = (long long)(u - r * per_row) * kLanes;
      v[j] = *reinterpret_cast<const U*>(x + so + r * src_ld + c);
      d[j] = dso + r * dst_ld + c;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (u0 + j * sweep < units) *reinterpret_cast<U*>(out + d[j]) = v[j];
}

// The parameter probe (tools/probe_launch.py): `units` 16-byte units
// copied in order, one a thread, without and with the 3 KB Pieces table as
// an unused parameter.
__global__ void __launch_bounds__(kCopyThreads)
    param_probe_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                       uint32_t units) {
  const uint32_t u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < units) out[u] = x[u];
}
__global__ void __launch_bounds__(kCopyThreads)
    param_probe_pieces_kernel(const uint4* __restrict__ x,
                              uint4* __restrict__ out, uint32_t units,
                              Pieces) {
  const uint32_t u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < units) out[u] = x[u];
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

constexpr int kParamMaps = 8;  // run maps in the kernel parameter
constexpr int kTmaTouchThreads = 128;
constexpr int kTmaSmem = 232448;  // the most a block may have

// The plan of a TMA copy (ops/probes.tma_plan): a kernel parameter.
struct TmaCopy {
  CUtensorMap src;              // (source lanes, source rows)
  CUtensorMap dst[kParamMaps];  // each run: (lanes, rows, pieces)
  const CUtensorMap* dst_mem;   // the run maps in device memory, or null
  int src_row[kMaxPieces];      // a piece's first row in the source map
  int first_box[kMaxPieces + 1];  // piece p's boxes: first_box[p] ..
  short run[kMaxPieces], slot[kMaxPieces];  // its run, its place there
  int n_pieces, n_runs;
  int lane0;      // the source lane of a piece's first load, 16-byte aligned
  int shift;      // the piece's first lane past lane0, 0 .. 7
  int box_rows, box_lanes, lane_boxes;  // the stored box; lane boxes a row
  int load_lanes;  // the loaded box's lanes: box_lanes, or 8 more to shift
  int stages, stride;  // the ring: stages of `stride` bytes
  int out_off;     // where a stage's shifted box starts (0: not shifted)
  float scale;
};

// kTouch: the warps touch each box in shared memory (scale != 1, or a
// shift), else one thread runs the copies.
template <bool kTouch>
__global__ void __launch_bounds__(kTmaTouchThreads)
    block_copy_tma_kernel(const __grid_constant__ TmaCopy a) {
  using namespace tma;
  extern __shared__ unsigned char raw[];
  const uint32_t align = ((smem_addr(raw) + 127) & ~127u) - smem_addr(raw);
  const uint32_t stride = a.stride;
  const uint32_t stage0 = smem_addr(raw) + align;
  const uint32_t bars = stage0 + a.stages * stride;
  const int n_mine =
      (a.first_box[a.n_pieces] - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const bool leader = threadIdx.x == 0;

  // Box j of this block: its piece, and its first lane and row there.
  auto locate = [&](int j, int& p, int& l0, int& r0) {
    const int b = blockIdx.x + j * gridDim.x;
    int lo = 0, hi = a.n_pieces - 1;  // the last piece starting by b
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (a.first_box[mid] <= b) lo = mid; else hi = mid - 1;
    }
    p = lo;
    const int k = b - a.first_box[p];
    r0 = k / a.lane_boxes * a.box_rows;
    l0 = k % a.lane_boxes * a.box_lanes;
  };
  auto load = [&](int j) {
    int p, l0, r0;
    locate(j, p, l0, r0);
    const int s = j % a.stages;
    mbar_expect_tx(bars + 8 * s, 2 * a.box_rows * a.load_lanes);
    tma_load_2d(stage0 + s * stride, &a.src, a.lane0 + l0, a.src_row[p] + r0,
                bars + 8 * s);
  };
  auto store = [&](int j) {
    int p, l0, r0;
    locate(j, p, l0, r0);
    const CUtensorMap* map =
        a.dst_mem ? a.dst_mem + a.run[p] : &a.dst[a.run[p]];
    tma_store_3d(map, l0, r0, a.slot[p],
                 stage0 + (j % a.stages) * stride + a.out_off);
  };

  if (leader) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
    if (a.dst_mem)
      for (int r = 0; r < a.n_runs; ++r) tensormap_acquire(a.dst_mem + r);
    for (int j = 0; j < min(a.stages, n_mine); ++j) load(j);
  }
  if (!kTouch && !leader) return;  // one thread copies
  if (kTouch) __syncthreads();     // the barriers are initialised
  const int units = a.box_rows * a.box_lanes / 8;  // 16-byte units a box
  for (int j = 0; j < n_mine; ++j) {
    const int s = j % a.stages;
    mbar_wait(bars + 8 * s, (j / a.stages) & 1);
    if (kTouch) {
      unsigned char* stage = raw + align + s * stride;
      uint4* box = reinterpret_cast<uint4*>(stage + a.out_off);
      const uint16_t* in = reinterpret_cast<const uint16_t*>(stage);
      const int per_row = a.box_lanes / 8;
      for (int i = threadIdx.x; i < units; i += blockDim.x) {
        union {
          uint4 q;
          uint16_t h[8];
        } v;
        if (a.shift) {  // row r, lanes c .. c + 7 of the stored box
          const int r = i / per_row, c = (i - r * per_row) * 8;
          const uint16_t* from = in + r * a.load_lanes + c + a.shift;
#pragma unroll
          for (int e = 0; e < 8; ++e) v.h[e] = from[e];
        } else {
          v.q = box[i];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) v.h[e] = scaled(v.h[e], a.scale);
        box[i] = v.q;
      }
    }
    fence_proxy_async();  // the box's writes before the TMA store's reads
    if (kTouch) __syncthreads();
    if (leader) {
      store(j);
      bulk_commit();
      // Refill the stage of box j - 1 once its store has read it.
      if (j >= 1 && j - 1 + a.stages < n_mine) {
        bulk_wait_read<1>();
        load(j - 1 + a.stages);
      }
    }
  }
  if (leader) bulk_wait_all();  // the stores are done with shared memory
}

static int copy_pieces(const long long* table, int n_pieces, Pieces* p) {
  if (n_pieces < 1 || n_pieces > kMaxPieces) return 0;
  for (int i = 0; i < 3 * n_pieces; ++i) p->v[i] = table[i];
  return 1;
}

// The direct copy's launch, with the table as a PieceTable<kN>.
template <int kN>
static void launch_block_copy(const uint16_t* x, uint16_t* out,
                              const long long* table, int n_pieces,
                              uint32_t per_row, long long src_ld,
                              long long dst_ld, bool vector, int blocks,
                              int per, cudaStream_t st) {
  PieceTable<kN> p = {};
  for (int i = 0; i < 3 * n_pieces; ++i) p.v[i] = table[i];
  const dim3 grid(blocks, n_pieces);
#define SHIFTNET_COPY(U, PER)                                   \
  block_copy_kernel<U, PER, kN><<<grid, kCopyThreads, 0, st>>>( \
      x, out, p, per_row, src_ld, dst_ld)
  if (vector && per == 1)
    SHIFTNET_COPY(uint4, 1);
  else if (vector)
    SHIFTNET_COPY(uint4, kCopyUnroll);
  else if (per == 1)
    SHIFTNET_COPY(uint16_t, 1);
  else
    SHIFTNET_COPY(uint16_t, kCopyUnroll);
#undef SHIFTNET_COPY
}

}  // namespace shiftnet

// x, out: bf16; table: n_pieces x (src, dst, rows) in elements.  route
// (ops/probes.py, copy_route): 0 single elements, 1 16-byte units (every
// row of both sides on the 16-byte grid, lanes a multiple of 8); blocks a
// piece and units a thread (per, 1 or kCopyUnroll) from copy_grid.
extern "C" int shiftnet_block_copy(const void* x, void* out,
                                   const long long* table, int n_pieces,
                                   int lanes, long long src_ld,
                                   long long dst_ld, int route, int blocks,
                                   int per, void* stream) {
  using namespace shiftnet;
  if (n_pieces < 1 || n_pieces > kMaxPieces || lanes < 1 || blocks < 1 ||
      (per != 1 && per != kCopyUnroll) || route < 0 || route > 1 ||
      (route && lanes % 8))
    return (int)cudaErrorInvalidValue;
  const uint32_t per_row = route ? lanes / 8 : lanes;
  const uint16_t* xs = static_cast<const uint16_t*>(x);
  uint16_t* o = static_cast<uint16_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pieces <= kFewPieces)
    launch_block_copy<kFewPieces>(xs, o, table, n_pieces, per_row, src_ld,
                                  dst_ld, route == 1, blocks, per, st);
  else
    launch_block_copy<kMaxPieces>(xs, o, table, n_pieces, per_row, src_ld,
                                  dst_ld, route == 1, blocks, per, st);
  return (int)cudaGetLastError();
}

// The parameter probe: `units` 16-byte units from x to out (both 16-byte
// aligned), with the 3 KB Pieces parameter (big) or without.
extern "C" int shiftnet_param_probe(int big, const void* x, void* out,
                                    int units, void* stream) {
  using namespace shiftnet;
  if (units < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (units + kCopyThreads - 1) / kCopyThreads;
  const uint4* xs = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (big) {
    Pieces p = {};
    param_probe_pieces_kernel<<<blocks, kCopyThreads, 0, st>>>(xs, o, units,
                                                               p);
  } else {
    param_probe_kernel<<<blocks, kCopyThreads, 0, st>>>(xs, o, units);
  }
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

// The staged copy on the TMA (block_copy_tma_kernel), as planned by
// ops/probes.tma_plan.  plan: source lanes and rows (its 2-D map), the
// destination row length, lanes, lane0, shift, box_rows, box_lanes,
// lane_boxes, load_lanes, stages, stride, out_off, blocks and the number
// of boxes; runs: n_runs x (dst,
// rows, pieces, step) in elements, each run's destination map; pieces:
// n_pieces x (src_row, run, slot, first_box).  maps: device memory for
// n_runs maps where n_runs > kParamMaps, else null.  Returns the
// cudaError_t of the launch, or 10000 + the CUresult of a map the driver
// refused to encode.
extern "C" int shiftnet_block_copy_tma(const void* x, void* out,
                                       const long long* plan,
                                       const long long* runs, int n_runs,
                                       const long long* pieces, int n_pieces,
                                       float scale, void* maps,
                                       void* stream) {
  using namespace shiftnet;
  const long long src_lanes = plan[0], src_rows = plan[1], dst_ld = plan[2],
                  lanes = plan[3];
  TmaCopy a;
  a.n_pieces = n_pieces;
  a.n_runs = n_runs;
  a.lane0 = (int)plan[4];
  a.shift = (int)plan[5];
  a.box_rows = (int)plan[6];
  a.box_lanes = (int)plan[7];
  a.lane_boxes = (int)plan[8];
  a.load_lanes = (int)plan[9];
  a.stages = (int)plan[10];
  a.stride = (int)plan[11];
  a.out_off = (int)plan[12];
  const long long blocks = plan[13], n_boxes = plan[14];
  a.scale = scale;
  // the stages, their barriers, and the slack to align the first
  const long long smem = 128 + (long long)a.stages * a.stride + 8 * a.stages;
  const bool shifted = a.shift != 0;
  if (n_pieces < 1 || n_pieces > kMaxPieces || n_runs < 1 ||
      n_runs > n_pieces || (n_runs > kParamMaps) != (maps != nullptr) ||
      a.stages < 1 || smem > kTmaSmem || a.stride % 128 || a.shift < 0 ||
      a.shift > 7 || a.lane0 % 8 || a.box_lanes % 8 ||
      a.load_lanes != a.box_lanes + (shifted ? 8 : 0) ||
      (shifted ? a.out_off < 2 * a.box_rows * a.load_lanes
               : a.out_off != 0) ||
      a.out_off % 128 ||
      a.out_off + 2LL * a.box_rows * a.box_lanes > a.stride || blocks < 1 ||
      blocks > n_boxes || n_boxes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_pieces; ++i) {
    a.src_row[i] = (int)pieces[4 * i];
    a.run[i] = (short)pieces[4 * i + 1];
    a.slot[i] = (short)pieces[4 * i + 2];
    a.first_box[i] = (int)pieces[4 * i + 3];
  }
  a.first_box[n_pieces] = (int)n_boxes;

  const uint64_t sdims[2] = {(uint64_t)src_lanes, (uint64_t)src_rows};
  const uint64_t sstride[1] = {2ULL * src_lanes};
  const uint32_t sbox[2] = {(uint32_t)a.load_lanes, (uint32_t)a.box_rows};
  int err = tma::encode_tiled(&a.src, x, 2, sdims, sstride, sbox,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return 10000 + err;
  std::vector<CUtensorMap> mem(maps ? n_runs : 0);
  for (int r = 0; r < n_runs; ++r) {
    const long long* run = runs + 4 * r;
    const uint64_t dims[3] = {(uint64_t)lanes, (uint64_t)run[1],
                              (uint64_t)run[2]};
    const uint64_t strides[2] = {2ULL * dst_ld, 2ULL * run[3]};
    const uint32_t box[3] = {(uint32_t)a.box_lanes, (uint32_t)a.box_rows, 1};
    err = tma::encode_tiled(maps ? &mem[r] : &a.dst[r],
                            static_cast<uint16_t*>(out) + run[0], 3, dims,
                            strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return 10000 + err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.dst_mem = static_cast<const CUtensorMap*>(maps);
  if (maps) {
    // From pageable memory: staged before the call returns, so `mem` may go.
    const cudaError_t e =
        cudaMemcpyAsync(maps, mem.data(), n_runs * sizeof(CUtensorMap),
                        cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
  }
  static const bool sized = [] {  // dynamic shared memory past 48 KB
    cudaFuncSetAttribute(block_copy_tma_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kTmaSmem);
    cudaFuncSetAttribute(block_copy_tma_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kTmaSmem);
    return true;
  }();
  (void)sized;
  if (scale != 1.f || shifted)
    block_copy_tma_kernel<true><<<(unsigned)blocks, kTmaTouchThreads,
                                  (int)smem, st>>>(a);
  else
    block_copy_tma_kernel<false><<<(unsigned)blocks, 32, (int)smem, st>>>(a);
  return (int)cudaGetLastError();
}
