"""The measurement probes' CUDA kernels and their plain versions.

Counterparts of the Pallas probe kernels of the JAX package's ``tools/``
(each wrapper names its own):

- ``mm_loop`` (``csrc/probe_mm.cu``): ``tools/microbench_mm.py:16``
  ``mm_loop_kernel``, the matrix-unit rate at a given product shape;
- ``block_copy`` (``csrc/probe_copy.cu``, direct): ``tools/
  probe_hbm_copy.py:29`` ``_copy_kernel``, ``tools/probe_copy_bw.py:45``
  ``_hbm_kernel`` and ``tools/probe_dma_align.py:64`` ``_slice_kernel``;
- ``block_copy_staged`` (``csrc/probe_copy.cu``, through shared memory):
  ``tools/microbench.py:126`` ``copy_kernel``, ``tools/probe_copy_bw.py:61``
  ``_vmem_kernel`` and ``tools/probe_dma_align.py:34`` ``_dma_off_kernel``;
- ``strided_copy`` (``csrc/probe_stride.cu``): ``tools/probe_chw.py:119``
  ``k_lane_stride``, ``:135`` ``k_sub_stride`` and ``:152`` ``k_store``.

Dispatch is that of ``ops/chw``: a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version (``*_plain``), any other device
raises.  Each launch adds one to ``LAUNCHES``.  Every probe takes bfloat16,
the type of the JAX tools.

The copies work from a list of pieces ``(sf, sr, df, dr, rows)``: rows
``sr .. sr + rows`` of frame ``sf`` of a ``(frames, rows, lanes)`` source go
to rows ``dr ..`` of frame ``df`` of the output, ``lanes`` lanes each,
starting at lane ``src_lane`` in the source and lane 0 in the output.
The output is ``torch.empty``: what no piece writes is undefined, so a
comparison reads only ``written``.
"""
from __future__ import annotations

import ctypes

import torch

from shiftnet_tpu_torch.ops import _build
from shiftnet_tpu_torch.ops.chw import SMEM_BYTES, _on_cuda, _stream

LAUNCHES = {'mm_loop': 0, 'block_copy': 0, 'block_copy_staged': 0,
            'strided_copy': 0}

SMS = 132          # streaming multiprocessors of an H100 SXM
MAX_PIECES = 128   # csrc/probe_copy.cu, kMaxPieces: the table is a kernel
                   # parameter
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

def mm_smem(bm: int, kp: int, bn: int) -> int:
    """Shared memory of one ``mm_loop`` block: the A panel [bm][kp + 8] and
    the B panel [kp][bn + pad] in bf16, each row an odd number of 16-byte
    units so that ``ldmatrix``'s eight row addresses hit distinct banks."""
    return 2 * (bm * (kp + 8) + kp * (bn + (8 if (bn // 8) % 2 == 0 else 16)))


def mm_layout(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(nf, wm, wn) of ``mm_loop``: each warp owns 32 rows and 8 * nf
    columns of the output, a block wm x wn warps.  The layout whose busiest
    SM holds the fewest warp tiles, then the one with more warps a block,
    among those whose panels fit in shared memory."""
    kp, np8 = _cdiv(k, 16) * 16, _cdiv(n, 8) * 8
    nf = min(4, np8 // 8)
    best = None
    for wm, wn in ((2, 4), (4, 2), (1, 8), (8, 1), (2, 2), (1, 4), (4, 1)):
        bm, bn = 32 * wm, 8 * nf * wn
        if mm_smem(bm, kp, bn) > SMEM_BYTES:
            continue
        blocks = _cdiv(m, bm) * _cdiv(np8, bn)
        cost = (_cdiv(blocks, SMS) * wm * wn, -wm * wn)
        if best is None or cost < best[0]:
            best = (cost, (nf, wm, wn))
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


def mm_loop(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """out = cast(sum over ``iters`` of a @ b), summed in float32 with both
    operands resident in shared memory (``tools/microbench_mm.py:16``
    ``mm_loop_kernel``).  a: (M, K), b: (K, N), bfloat16."""
    if not _on_cuda(a):
        return mm_loop_plain(a, b, iters)
    _check_bf16('mm_loop', a, b)
    m, k = a.shape
    if b.shape[0] != k or iters < 1:
        raise ValueError(f'mm_loop: a {tuple(a.shape)}, b {tuple(b.shape)}, '
                         f'iters {iters}')
    n = b.shape[1]
    nf, wm, wn = mm_layout(m, k, n)
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    _build.check(_build.library().shiftnet_mm_loop(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, iters, nf, wm,
        wn, _stream()), 'mm_loop')
    LAUNCHES['mm_loop'] += 1
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


def block_copy(x: torch.Tensor, out_shape, pieces, lanes: int, *,
               src_lane: int = 0) -> torch.Tensor:
    """The pieces copied device memory to device memory, 16 bytes a thread
    where source and destination allow it (``tools/probe_hbm_copy.py:29``
    ``_copy_kernel``, ``tools/probe_copy_bw.py:45`` ``_hbm_kernel``,
    ``tools/probe_dma_align.py:64`` ``_slice_kernel``)."""
    if not _on_cuda(x):
        return block_copy_plain(x, out_shape, pieces, lanes, src_lane)
    return _launch_copy(_build.library().shiftnet_block_copy, 'block_copy',
                        x, tuple(out_shape), pieces, lanes, src_lane)


def block_copy_staged(x: torch.Tensor, out_shape, pieces, lanes: int, *,
                      tile: int | None = None, scale: float = 1.0,
                      src_lane: int = 0) -> torch.Tensor:
    """The pieces copied through shared memory with ``cp.async``, double
    buffered, times ``scale`` (``tools/microbench.py:126`` ``copy_kernel``,
    ``tools/probe_copy_bw.py:61`` ``_vmem_kernel``,
    ``tools/probe_dma_align.py:34`` ``_dma_off_kernel``).  One block takes
    one piece's ``tile`` lanes (by default ``staged_tile``); the last tile
    of a piece may be narrower."""
    if not _on_cuda(x):
        return block_copy_plain(x, out_shape, pieces, lanes, src_lane,
                                scale)
    tile = staged_tile(lanes, len(pieces)) if tile is None else tile
    if not 0 < tile <= lanes:
        raise ValueError(f'block_copy_staged: tile {tile} of {lanes} lanes')
    return _launch_copy(_build.library().shiftnet_block_copy_staged,
                        'block_copy_staged', x, tuple(out_shape), pieces,
                        lanes, src_lane, tile,
                        ctypes.c_float(scale))


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
