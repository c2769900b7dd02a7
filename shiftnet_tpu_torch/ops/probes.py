"""The measurement probes' CUDA kernels and their plain versions.

Counterparts of the Pallas probe kernels of the JAX package's ``tools/``
(each wrapper names its own):

- ``mm_loop`` (``csrc/probe_mm.cu``): ``tools/microbench_mm.py:16``
  ``mm_loop_kernel``, the matrix-unit rate at a given product shape;
- ``block_copy`` (``csrc/probe_copy.cu``, direct, in 16-byte units where
  ``copy_route`` says so): ``tools/
  probe_hbm_copy.py:29`` ``_copy_kernel``, ``tools/probe_copy_bw.py:45``
  ``_hbm_kernel`` and ``tools/probe_dma_align.py:64`` ``_slice_kernel``;
- ``block_copy_staged`` (``csrc/probe_copy.cu``, through shared memory, on
  the TMA where tensor maps describe the copy, ``staged_route``):
  ``tools/microbench.py:126`` ``copy_kernel``, ``tools/probe_copy_bw.py:61``
  ``_vmem_kernel`` and ``tools/probe_dma_align.py:34`` ``_dma_off_kernel``;
- ``strided_copy`` (``csrc/probe_stride.cu``): ``tools/probe_chw.py:119``
  ``k_lane_stride``, ``:135`` ``k_sub_stride`` and ``:152`` ``k_store``.

Dispatch is that of ``ops/chw``: a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version (``*_plain``), any other device
raises.  Each launch adds one to ``LAUNCHES`` and writes the route it took
to ``ROUTES``.  Every probe takes bfloat16,
the type of the JAX tools.

The copies work from a list of pieces ``(sf, sr, df, dr, rows)``: rows
``sr .. sr + rows`` of frame ``sf`` of a ``(frames, rows, lanes)`` source go
to rows ``dr ..`` of frame ``df`` of the output, ``lanes`` lanes each,
starting at lane ``src_lane`` in the source and lane 0 in the output.
The output is ``torch.empty``: what no piece writes is undefined, so a
comparison reads only ``written``.
"""
from __future__ import annotations

import bisect
import ctypes
from dataclasses import dataclass

import torch

from shiftnet_tpu_torch.ops import _build
from shiftnet_tpu_torch.ops.chw import (SM_SMEM_BYTES, SMEM_BYTES, _on_cuda,
                                        _stream)

LAUNCHES = {'mm_loop': 0, 'block_copy': 0, 'block_copy_staged': 0,
            'strided_copy': 0}
# The route of each wrapper's last launch: mm_loop's tile (``'wgmma
# BMxBN'``), the direct copy's unit (``copy_route``), the staged copy's
# ``staged_route``.
ROUTES: dict[str, str] = {}

SMS = 132          # streaming multiprocessors of an H100 SXM
MAX_PIECES = 128   # csrc/probe_copy.cu, kMaxPieces: the staged copies'
                   # table is a kernel parameter
# The direct copy (csrc/probe_copy.cu, block_copy_kernel).
COPY_THREADS = 256   # kCopyThreads
COPY_UNROLL = 4      # kCopyUnroll: units a thread loads before it stores
COPY_WAVE = SMS * 2048 // COPY_THREADS  # blocks of one wave, 8 an SM
FEW_PIECES = 4       # kFewPieces: tables this short take a 96-byte parameter
# The TMA copy (csrc/probe_copy.cu, block_copy_tma_kernel).
TMA_STAGES = 4       # the ring of shared-memory stages of a persistent block
STAGE_BYTES = 24576  # a stage at most: a 40 x 256 box
PARAM_MAPS = 8       # kParamMaps: run maps that travel in the kernel parameter
BOX_MAX = 256        # a tensor map's box dimension at most
LINE_LANES = 64      # a 128-byte line: box lanes come in whole lines
SMALL_LANES = 64     # box lanes of a small copy at most
TOUCH_THREADS = 128  # kTmaTouchThreads: a block that scales or shifts
STRIDE_MODES = {'lane': 0, 'block': 1, 'store': 2}
STRIDE_BLOCK = 128  # lanes per block of the row-block stride (k_sub_stride)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_bf16(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{name}: dtype {t.dtype}; the probes take '
                            'bfloat16')
        if t.device != ts[0].device:
            raise ValueError(f'{name}: tensors on {t.device} and '
                             f'{ts[0].device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')


# -- mm_loop ------------------------------------------------------------------

# csrc/probe_mm.cu: the wgmma widths instantiated (BN), a K chunk (one
# 128-byte swizzle row of bf16), a B box (64 k rows of 128 bytes).
MM_WIDTHS = (24, 32, 64, 96, 128, 160)
MM_CHUNK = 64
MM_ATOM = 8192
SWIZZLE_ATOM = 1024  # eight 128-byte rows: the span of the 128-byte swizzle
# A block of one warpgroup keeps one chain of dependent products in flight;
# at equal work it ran 4-18 % slower than a block of two (every tile at the
# dense reference and both gate shapes, tools/microbench_mm.py --plans;
# NVIDIA H100 80GB HBM3, 700 W), so its clocks count a tenth more.
MM_ONE_GROUP = 1.1


def swizzle128(off: int) -> int:
    """Where the TMA's 128-byte swizzle puts the byte at ``off`` of a box
    (from a 1024-byte aligned start): the 16-byte unit u of 128-byte row r
    moves to unit u ^ (r % 8) of that row."""
    return off ^ (((off >> 7) & 7) << 4)


@dataclass(frozen=True)
class MmPlan:
    """One ``mm_loop`` launch (``csrc/probe_mm.cu``), byte offsets from the
    1024-byte aligned start of the block's shared memory.

    A block owns a ``bm`` x ``bn`` output tile, 64 rows per warpgroup.  The
    A panel is ``chunks`` chunks of ``bm`` rows by 64 k (``a_chunk``
    bytes), K-major; the B panel starts at ``b_off``, ``chunks`` chunks of
    ``atoms`` boxes of 64 k rows by 64 columns (``b_chunk`` bytes), N-major;
    both as the TMA lands them under the 128-byte swizzle (``a_addr``,
    ``b_addr``).  A warpgroup's rows start ``a_wg`` into a chunk; the k-th
    16-deep step of a chunk starts ``a_k`` (A) and ``b_k`` (B) further.
    The descriptors: A's stride byte offset ``a_sbo`` (between 8-row
    groups), B's leading byte offset ``b_lbo`` (between 64-column boxes)
    and stride byte offset ``b_sbo`` (between 8-k groups).  ``ksteps``
    products of depth 16 an iteration; the chunks' barriers at
    ``bar_off``; ``smem`` bytes with the slack that aligns the start."""

    bm: int
    bn: int
    chunks: int
    ksteps: int
    atoms: int
    a_chunk: int
    b_chunk: int
    b_off: int
    bar_off: int
    smem: int
    a_wg: int
    a_k: int
    b_k: int
    a_sbo: int
    b_lbo: int
    b_sbo: int
    grid: tuple[int, int]

    def args(self) -> list[int]:
        """The kernel's plan, in the order ``shiftnet_mm_loop`` reads it."""
        return [self.bm, self.bn, self.chunks, self.ksteps, self.atoms,
                self.a_chunk, self.b_chunk, self.b_off, self.bar_off,
                self.smem, self.a_wg, self.a_k, self.b_k, self.a_sbo,
                self.b_lbo, self.b_sbo]

    def a_addr(self, row: int, k: int) -> int:
        """Byte offset of A's element (tile row, k), where the TMA puts it:
        chunk k // 64, row ``row`` of its box."""
        c, e = divmod(k, MM_CHUNK)
        return c * self.a_chunk + swizzle128(128 * row + 2 * e)

    def b_addr(self, k: int, col: int) -> int:
        """Byte offset of B's element (k, tile column), where the TMA puts
        it: chunk k // 64, box col // 64, row k % 64 of the box."""
        c, r = divmod(k, MM_CHUNK)
        j, e = divmod(col, 64)
        return (self.b_off + c * self.b_chunk + j * MM_ATOM
                + swizzle128(128 * r + 2 * e))

    def a_start(self, wg: int, step: int) -> int:
        """Start of warpgroup ``wg``'s A descriptor at k-step ``step``."""
        c, s = divmod(step, 4)
        return wg * self.a_wg + c * self.a_chunk + s * self.a_k

    def b_start(self, step: int) -> int:
        """Start of the B descriptor at k-step ``step``."""
        c, s = divmod(step, 4)
        return self.b_off + c * self.b_chunk + s * self.b_k


def mm_tile(bm: int, bn: int, m: int, k: int, n: int) -> MmPlan:
    """The plan of a ``bm`` x ``bn`` tile (``bm`` 64 or 128, ``bn`` one of
    ``MM_WIDTHS``) for a (m, k) @ (k, n) product."""
    if bm not in (64, 128) or bn not in MM_WIDTHS:
        raise ValueError(f'mm_loop: no {bm} x {bn} tile')
    chunks, atoms = _cdiv(k, MM_CHUNK), _cdiv(bn, 64)
    a_chunk, b_chunk = 128 * bm, MM_ATOM * atoms
    b_off = chunks * a_chunk
    bar_off = b_off + chunks * b_chunk
    return MmPlan(
        bm=bm, bn=bn, chunks=chunks, ksteps=_cdiv(k, 16), atoms=atoms,
        a_chunk=a_chunk, b_chunk=b_chunk, b_off=b_off, bar_off=bar_off,
        smem=SWIZZLE_ATOM + bar_off + 8 * chunks, a_wg=64 * 128, a_k=32,
        b_k=16 * 128, a_sbo=SWIZZLE_ATOM, b_lbo=MM_ATOM, b_sbo=SWIZZLE_ATOM,
        grid=(_cdiv(n, bn), _cdiv(m, bm)))


def mm_plan(m: int, k: int, n: int) -> MmPlan:
    """The tile of ``mm_loop`` for a (m, k) @ (k, n) product.

    Among the tiles whose panels fit in shared memory (BM 64 or 128, one or
    two warpgroups; BN of ``MM_WIDTHS`` up to the narrowest that covers
    N), the one whose busiest SM spends the fewest clocks an iteration:
    its waves over the SMs, times the products of a tile, each an m64nBNk16
    at the larger of its tensor-core clocks (BN / 2, at 4096 operations a
    clock) and its operand reads from shared memory (16 + BN / 4, 2048 + 32
    BN bytes at 128 a clock), times ``MM_ONE_GROUP`` for a tile of one
    warpgroup; then the narrower BN, then the taller BM.  Raises where a
    tensor map cannot describe the operands: K or N not a multiple of 8
    elements (a row stride not whole 16-byte units)."""
    if k % 8 or n % 8 or m < 1 or k < 1:
        raise ValueError(f'mm_loop: ({m}, {k}) @ ({k}, {n}): K and N must '
                         'be multiples of 8 (a tensor map\'s 16-byte row '
                         'strides)')
    cover = min([w for w in MM_WIDTHS if w >= n] or [MM_WIDTHS[-1]])
    best = None
    for bm in (64, 128):
        for bn in MM_WIDTHS:
            plan = mm_tile(bm, bn, m, k, n)
            if bn > cover or plan.smem > SMEM_BYTES:
                continue
            waves = _cdiv(plan.grid[0] * plan.grid[1], SMS)
            clocks = (waves * bm // 64 * plan.ksteps
                      * max(bn / 2, 16 + bn / 4)
                      * (MM_ONE_GROUP if bm == 64 else 1.0))
            key = (clocks, bn, -bm)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f'mm_loop: K={k} panels do not fit in shared memory')
    return best[1]


def mm_loop_plain(a: torch.Tensor, b: torch.Tensor,
                  iters: int) -> torch.Tensor:
    r = a.float() @ b.float()
    acc = torch.zeros_like(r)
    for _ in range(iters):
        acc += r
    return acc.to(a.dtype)


def mm_loop(a: torch.Tensor, b: torch.Tensor, iters: int, *,
            plan: MmPlan | None = None) -> torch.Tensor:
    """out = cast(sum over ``iters`` of a @ b), summed in float32 with both
    operands resident in shared memory (``tools/microbench_mm.py:16``
    ``mm_loop_kernel``).  a: (M, K), b: (K, N), bfloat16, 16-byte aligned,
    K and N multiples of 8.  ``plan``: the tile, by default ``mm_plan``'s
    (a measurement tool may time another of ``mm_tile``)."""
    if not _on_cuda(a):
        return mm_loop_plain(a, b, iters)
    _check_bf16('mm_loop', a, b)
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k or iters < 1:
        raise ValueError(f'mm_loop: a {tuple(a.shape)}, b {tuple(b.shape)}, '
                         f'iters {iters}')
    n = b.shape[1]
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError('mm_loop: a and b must start 16-byte aligned (a '
                         'tensor map\'s base)')
    plan = plan or mm_plan(m, k, n)
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    args = plan.args()
    _build.check(_build.library().shiftnet_mm_loop(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, iters,
        (ctypes.c_longlong * len(args))(*args), _stream()), 'mm_loop')
    LAUNCHES['mm_loop'] += 1
    ROUTES['mm_loop'] = f'wgmma {plan.bm}x{plan.bn}'
    return out


# -- block_copy, block_copy_staged --------------------------------------------

def hbm_copy_pieces(t: int, row0: int, rows: int) -> list[tuple]:
    """``tools/probe_hbm_copy.py:29``: frame t takes rows ``row0 ..`` of
    frame max(t - 1, 0)."""
    return [(max(ti - 1, 0), row0, ti, row0, rows) for ti in range(t)]


def shift_pieces(t: int, pp: int, cb: int, half: int) -> list[tuple]:
    """``tools/probe_copy_bw.py:45``: the half-channel permutation of each
    of ``pp`` channel blocks of ``cb`` rows; frame 0 reads frame t - 1."""
    out = []
    for ti in range(t):
        for p in range(pp):
            out.append(((ti - 1) % t, p * cb + half, ti, p * cb, half))
            out.append((ti, p * cb, ti, p * cb + half, half))
    return out


def slab_pieces(h: int, rows: int) -> list[tuple]:
    """``tools/microbench.py:126``: frame 0 in slabs of ``rows`` rows."""
    return [(0, hi * rows, 0, hi * rows, rows) for hi in range(h // rows)]


def piece_table(name, x, out_shape, pieces, lanes, src_lane=0):
    """Validate a copy; returns its pieces as (src, dst, rows) element
    offsets into the flattened source and output, the kernels' table."""
    if x.dim() != 3 or len(out_shape) != 3:
        raise ValueError(f'{name}: source {tuple(x.shape)} and output '
                         f'{tuple(out_shape)} must be (frames, rows, lanes)')
    if not 0 < len(pieces) <= MAX_PIECES:
        raise ValueError(f'{name}: {len(pieces)} pieces (1 to {MAX_PIECES})')
    (sfr, srows, sl), (dfr, drows, dl) = x.shape, out_shape
    if lanes < 1 or src_lane < 0 or src_lane + lanes > sl or lanes > dl:
        raise ValueError(f'{name}: lanes {src_lane}+{lanes} of {sl}, '
                         f'{lanes} of {dl}')
    table = []
    for sf, sr, df, dr, rows in pieces:
        if not (0 <= sf < sfr and 0 <= df < dfr and rows > 0 and sr >= 0
                and dr >= 0 and sr + rows <= srows and dr + rows <= drows):
            raise ValueError(f'{name}: piece {(sf, sr, df, dr, rows)} outside '
                             f'{tuple(x.shape)} -> {tuple(out_shape)}')
        table += [(sf * srows + sr) * sl + src_lane,
                  (df * drows + dr) * dl, rows]
    return table


def staged_tile(lanes: int, n_pieces: int) -> int:
    """The lane tile that gives ``block_copy_staged`` 4 blocks an SM where
    the pieces are large enough, and never under 64 lanes (a 128-byte
    line): a block walks its tile's chunks one after another, so a few
    large blocks wait out one memory round trip per chunk."""
    want = _cdiv(_cdiv(lanes * n_pieces, 4 * SMS), 8) * 8
    return min(lanes, max(64, want))


def staged_route(x: torch.Tensor, out_shape) -> str:
    """``'tma'`` where tensor maps describe a staged copy from x into a
    fresh ``out_shape`` output: x 16-byte aligned, the source's and the
    output's rows a whole number of 16-byte units (a map's strides), the
    source's rows within a coordinate's 31 bits; else ``'cp.async'``."""
    (sfr, srows, sl), dl = x.shape, out_shape[2]
    ok = (x.data_ptr() % 16 == 0 and sl % 8 == 0 and dl % 8 == 0
          and sfr * srows < 2 ** 31)
    return 'tma' if ok else 'cp.async'


@dataclass(frozen=True)
class TmaPlan:
    """A staged copy on the TMA (``csrc/probe_copy.cu``,
    ``block_copy_tma_kernel``), in elements.

    The source is one 2-D map, ``src_lanes`` lanes by ``src_rows`` rows.
    Each of ``runs``, ``(dst, rows, n, step)``, is a destination map: n
    pieces of ``rows`` rows by ``lanes`` lanes, piece i at ``dst + i *
    step`` with rows ``dst_ld`` apart; a store clips at its run's rows and
    lanes.  ``pieces`` are ``(src_row, run, slot, first_box)``: a piece's
    first row in the source map, its run and place there, and its first
    box.  Box b of piece p covers the piece's rows from ``k // lane_boxes *
    box_rows`` and lanes from ``k % lane_boxes * box_lanes``, k = b -
    first_box.  A load must start on the 16-byte grid, so it reads
    ``load_lanes`` lanes from source lane ``src_lane - shift`` plus that
    lane, and the box is its lanes ``shift ..``: with a shift the stored
    box lies ``out_off`` bytes into its stage.  Block i of ``blocks`` takes
    boxes i, i + blocks, ... through a ring of ``stages`` stages of
    ``stride`` bytes."""

    src_lanes: int
    src_rows: int
    dst_ld: int
    lanes: int
    src_lane: int
    shift: int
    box_rows: int
    box_lanes: int
    lane_boxes: int
    load_lanes: int
    stages: int
    stride: int
    out_off: int
    blocks: int
    n_boxes: int
    runs: tuple[tuple[int, int, int, int], ...]
    pieces: tuple[tuple[int, int, int, int], ...]

    def smem(self) -> int:
        """Dynamic shared memory of a block: the stages, their barriers,
        and the slack to align the first to 128 bytes."""
        return 128 + self.stages * (self.stride + 8)

    def locate(self, b: int) -> tuple[int, int, int]:
        """(piece, first row, first lane) of box b, as the kernel finds
        them."""
        p = bisect.bisect_right([q[3] for q in self.pieces], b) - 1
        k = b - self.pieces[p][3]
        return (p, k // self.lane_boxes * self.box_rows,
                k % self.lane_boxes * self.box_lanes)


def _runs(pieces, drows: int, dl: int):
    """Group the pieces, in order, into runs of equal rows whose
    destinations are equally spaced and do not overlap: [(dst, rows, n,
    step)] and each piece's (run, slot)."""
    runs, where = [], []
    for _, _, df, dr, rows in pieces:
        dst = (df * drows + dr) * dl
        if runs and runs[-1][1] == rows:
            d0, _, n, step = runs[-1]
            if n == 1 and dst - d0 >= rows * dl:
                step = dst - d0
            if dst - d0 == n * step:
                runs[-1] = (d0, rows, n + 1, step)
                where.append((len(runs) - 1, n))
                continue
        runs.append((dst, rows, 1, rows * dl))
        where.append((len(runs) - 1, 0))
    return runs, where


def _stage(box_rows: int, box_lanes: int, shift: int) -> tuple[int, int]:
    """(stride, out_off) of a stage: the loaded box, and after it the
    shifted box where there is a shift, each at 128-byte alignment."""
    line = 128
    loaded = _cdiv(2 * box_rows * (box_lanes + (8 if shift else 0)),
                   line) * line
    if not shift:
        return loaded, 0
    return loaded + _cdiv(2 * box_rows * box_lanes, line) * line, loaded


def tma_plan(x_shape, out_shape, pieces, lanes: int,
             src_lane: int = 0) -> TmaPlan:
    """The boxes of a staged copy on the TMA (``TmaPlan``).  A box takes
    the pieces' rows whole up to 256 (else in equal row blocks), and as
    many lanes as fit a ``STAGE_BYTES`` stage, in whole 128-byte lines
    where it is that wide.  A copy under ``SMS`` stages' bytes takes boxes
    of at most ``SMALL_LANES`` lanes, so that many are in flight at once.
    Where one wave of one-stage blocks holds every box, each block takes
    one box; else the blocks are persistent, ``TMA_STAGES`` stages each, as
    many as shared memory keeps on every SM, with the same number of boxes
    each (one more for some)."""
    (_, srows_f, sl), (_, drows, dl) = tuple(x_shape), tuple(out_shape)
    rows = [p[4] for p in pieces]
    shift = src_lane % 8
    box_rows = _cdiv(max(rows), _cdiv(max(rows), BOX_MAX))
    cap = BOX_MAX - (8 if shift else 0)
    while _stage(box_rows, cap, shift)[0] > STAGE_BYTES:
        cap -= 8
    if 2 * sum(rows) * lanes < SMS * STAGE_BYTES:
        cap = min(cap, SMALL_LANES)
    if cap >= LINE_LANES:
        cap -= cap % LINE_LANES
    box_lanes = min(cap, _cdiv(lanes, 8) * 8)
    lane_boxes = _cdiv(lanes, box_lanes)
    first, n_boxes = [], 0
    for r in rows:
        first.append(n_boxes)
        n_boxes += _cdiv(r, box_rows) * lane_boxes
    runs, where = _runs(pieces, drows, dl)
    stride, out_off = _stage(box_rows, box_lanes, shift)
    # blocks an SM: shared memory (and 1 KB the card keeps a block), threads
    per_sm = min(SM_SMEM_BYTES // (128 + stride + 8 + 1024),
                 2048 // TOUCH_THREADS)
    if n_boxes <= SMS * per_sm:
        blocks, stages = n_boxes, 1
    else:
        stages = TMA_STAGES
        most = SMS * (SM_SMEM_BYTES // (128 + stages * (stride + 8) + 1024))
        blocks = _cdiv(n_boxes, _cdiv(n_boxes, most))
    return TmaPlan(
        src_lanes=sl, src_rows=x_shape[0] * srows_f, dst_ld=dl, lanes=lanes,
        src_lane=src_lane, shift=shift, box_rows=box_rows,
        box_lanes=box_lanes, lane_boxes=lane_boxes,
        load_lanes=box_lanes + (8 if shift else 0), stages=stages,
        stride=stride, out_off=out_off, blocks=blocks, n_boxes=n_boxes,
        runs=tuple(runs),
        pieces=tuple((sf * srows_f + sr, run, slot, f)
                     for (sf, sr, _, _, _), (run, slot), f
                     in zip(pieces, where, first)))


def block_copy_plain(x, out_shape, pieces, lanes, src_lane=0, scale=1.0):
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    for sf, sr, df, dr, rows in pieces:
        v = x[sf, sr:sr + rows, src_lane:src_lane + lanes]
        out[df, dr:dr + rows, :lanes] = (
            v if scale == 1.0 else v * scale)
    return out


def written(out: torch.Tensor, pieces, lanes: int) -> torch.Tensor:
    """The elements of ``out`` that the pieces write, flattened in piece
    order: what a copy's result is compared on."""
    return torch.cat([out[df, dr:dr + rows, :lanes].flatten()
                      for _, _, df, dr, rows in pieces])


def _launch_copy(fn, name, x, out_shape, pieces, lanes, src_lane, *extra):
    _check_bf16(name, x)
    table = piece_table(name, x, out_shape, pieces, lanes, src_lane)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    arr = (ctypes.c_longlong * len(table))(*table)
    _build.check(fn(x.data_ptr(), out.data_ptr(), arr, len(pieces), lanes,
                    x.shape[2], out_shape[2], *extra, _stream()), name)
    LAUNCHES[name] += 1
    return out


COPY_ROUTES = {'element': 0, 'vector': 1}


def copy_route(x: torch.Tensor, out: torch.Tensor, table,
               lanes: int) -> str:
    """The direct copy's unit: ``'vector'`` (16 bytes, 8 lanes) where every
    row of every piece starts on the 16-byte grid on both sides, else
    ``'element'``."""
    sl, dl = x.shape[2], out.shape[2]
    grid = (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and lanes % 8 == 0 and sl % 8 == 0 and dl % 8 == 0
            and all(v % 8 == 0 for i, v in enumerate(table) if i % 3 < 2))
    return 'vector' if grid else 'element'


def copy_grid(units: int, n_pieces: int) -> tuple[int, int]:
    """(blocks a piece, units a thread) of the direct copy, for pieces of
    at most ``units`` units, every thread taking one batch: one unit a
    thread where a wave of blocks (``COPY_WAVE``) holds the copy so, else
    ``COPY_UNROLL`` units on as many blocks as that takes."""
    per = (1 if _cdiv(units, COPY_THREADS) * n_pieces <= COPY_WAVE
           else COPY_UNROLL)
    return _cdiv(units, per * COPY_THREADS), per


def block_copy(x: torch.Tensor, out_shape, pieces, lanes: int, *,
               src_lane: int = 0) -> torch.Tensor:
    """The pieces copied device memory to device memory
    (``tools/probe_hbm_copy.py:29`` ``_copy_kernel``,
    ``tools/probe_copy_bw.py:45`` ``_hbm_kernel``,
    ``tools/probe_dma_align.py:64`` ``_slice_kernel``), in the units of
    ``copy_route`` on the grid of ``copy_grid``."""
    if not _on_cuda(x):
        return block_copy_plain(x, out_shape, pieces, lanes, src_lane)
    _check_bf16('block_copy', x)
    out_shape = tuple(out_shape)
    table = piece_table('block_copy', x, out_shape, pieces, lanes, src_lane)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    route = copy_route(x, out, table, lanes)
    units = max(p[4] for p in pieces) * (
        lanes if route == 'element' else lanes // 8)
    if units >= 2 ** 31:
        raise ValueError(f'block_copy: {units} units in a piece (a 32-bit '
                         'index)')
    blocks, per = copy_grid(units, len(pieces))
    _build.check(_build.library().shiftnet_block_copy(
        x.data_ptr(), out.data_ptr(), (ctypes.c_longlong * len(table))(*table),
        len(pieces), lanes, x.shape[2], out_shape[2], COPY_ROUTES[route],
        blocks, per, _stream()), 'block_copy')
    LAUNCHES['block_copy'] += 1
    ROUTES['block_copy'] = route
    return out


def param_probe(x: torch.Tensor, out: torch.Tensor, big: bool) -> None:
    """Copy x into out (bfloat16, contiguous, 16-byte aligned, a multiple
    of 8 elements) in 16-byte units, one a thread, with the 3 KB piece
    table of the staged copies as an unused kernel parameter (``big``) or
    without: the parameter's cost (``tools/probe_launch.py``)."""
    if (x.numel() != out.numel() or x.numel() % 8 or x.data_ptr() % 16
            or out.data_ptr() % 16 or not (x.is_contiguous()
                                           and out.is_contiguous())):
        raise ValueError('param_probe: x and out must be contiguous, '
                         '16-byte aligned, of one size in 16-byte units')
    _build.check(_build.library().shiftnet_param_probe(
        int(big), x.data_ptr(), out.data_ptr(), x.numel() // 8, _stream()),
        'param_probe')


def _launch_tma(x, out_shape, pieces, lanes, src_lane, scale):
    _check_bf16('block_copy_staged', x)
    piece_table('block_copy_staged', x, out_shape, pieces, lanes, src_lane)
    plan = tma_plan(x.shape, out_shape, pieces, lanes, src_lane)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    head = (plan.src_lanes, plan.src_rows, plan.dst_ld, plan.lanes,
            plan.src_lane - plan.shift, plan.shift, plan.box_rows,
            plan.box_lanes, plan.lane_boxes, plan.load_lanes, plan.stages,
            plan.stride, plan.out_off, plan.blocks, plan.n_boxes)
    runs = [v for run in plan.runs for v in run]
    table = [v for piece in plan.pieces for v in piece]
    # more run maps than the kernel parameter holds: device memory, 128
    # bytes a map, written by the launch
    maps = (torch.empty(128 * len(plan.runs), dtype=torch.uint8,
                        device=x.device)
            if len(plan.runs) > PARAM_MAPS else None)

    def arr(v):
        return (ctypes.c_longlong * len(v))(*v)
    _build.check(_build.library().shiftnet_block_copy_tma(
        x.data_ptr(), out.data_ptr(), arr(head), arr(runs), len(plan.runs),
        arr(table), len(plan.pieces), ctypes.c_float(scale),
        None if maps is None else maps.data_ptr(), _stream()),
        'block_copy_staged')
    LAUNCHES['block_copy_staged'] += 1
    ROUTES['block_copy_staged'] = 'tma'
    return out


def block_copy_staged(x: torch.Tensor, out_shape, pieces, lanes: int, *,
                      tile: int | None = None, scale: float = 1.0,
                      src_lane: int = 0) -> torch.Tensor:
    """The pieces copied through shared memory, times ``scale``
    (``tools/microbench.py:126`` ``copy_kernel``,
    ``tools/probe_copy_bw.py:61`` ``_vmem_kernel``,
    ``tools/probe_dma_align.py:34`` ``_dma_off_kernel``).  On the TMA in
    the boxes of ``tma_plan`` where ``staged_route`` says so; else with
    ``cp.async``, double buffered, one block taking one piece's ``tile``
    lanes (by default ``staged_tile``; the last tile of a piece may be
    narrower).  ``tile`` is the cp.async route's work split; the TMA route
    splits by boxes."""
    if not _on_cuda(x):
        return block_copy_plain(x, out_shape, pieces, lanes, src_lane,
                                scale)
    out_shape = tuple(out_shape)
    tile = staged_tile(lanes, len(pieces)) if tile is None else tile
    if not 0 < tile <= lanes:
        raise ValueError(f'block_copy_staged: tile {tile} of {lanes} lanes')
    if x.dim() == 3 and len(out_shape) == 3 and staged_route(
            x, out_shape) == 'tma':
        return _launch_tma(x, out_shape, pieces, lanes, src_lane, scale)
    out = _launch_copy(_build.library().shiftnet_block_copy_staged,
                       'block_copy_staged', x, out_shape, pieces, lanes,
                       src_lane, tile, ctypes.c_float(scale))
    ROUTES['block_copy_staged'] = 'cp.async'
    return out


# -- strided_copy -------------------------------------------------------------

def strided_copy_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    c, m = x.shape
    if mode == 'lane':
        return x[:, ::2].contiguous()
    if mode == 'block':
        return x.reshape(c, m // STRIDE_BLOCK, STRIDE_BLOCK)[:, ::2].reshape(
            c, m // 2)
    out = torch.zeros((c, 2 * m), dtype=x.dtype, device=x.device)
    out[:, ::2] = x
    return out


def strided_copy(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Stride-2 access along the lanes of a (rows, m) tensor
    (``tools/probe_chw.py``):

    - ``lane``: out = x[:, ::2] (``:119`` ``k_lane_stride``);
    - ``block``: every other block of 128 lanes,
      x.reshape(rows, m / 128, 128)[:, ::2] (``:135`` ``k_sub_stride``);
    - ``store``: out = zeros(rows, 2m); out[:, ::2] = x (``:152``
      ``k_store``).
    """
    if mode not in STRIDE_MODES:
        raise ValueError(f'strided_copy: mode {mode!r}')
    if not _on_cuda(x):
        return strided_copy_plain(x, mode)
    _check_bf16('strided_copy', x)
    if x.dim() != 2:
        raise ValueError(f'strided_copy: x {tuple(x.shape)} must be 2-D')
    rows, m = x.shape
    unit = 2 * STRIDE_BLOCK if mode == 'block' else 16
    if m % unit or x.data_ptr() % 16:
        raise ValueError(f'strided_copy: {mode} needs lanes a multiple of '
                         f'{unit} ({m}) and a 16-byte aligned start')
    m_out = 2 * m if mode == 'store' else m // 2
    out = torch.empty((rows, m_out), dtype=x.dtype, device=x.device)
    _build.check(_build.library().shiftnet_strided_copy(
        x.data_ptr(), out.data_ptr(), rows, m_out, STRIDE_MODES[mode],
        STRIDE_BLOCK, _stream()), 'strided_copy')
    LAUNCHES['strided_copy'] += 1
    return out
