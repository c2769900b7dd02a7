"""Probe: the bandwidth of the temporal half-channel permutation, copied
directly and staged through shared memory, beside ``Tensor.copy_`` and
``torch.cat``.

  python -m shiftnet_tpu_torch.tools.probe_copy_bw

The permutation: for each of pp channel blocks of cb rows,
y[t, p*cb : p*cb + half] = x[(t - 1) mod T, p*cb + half : p*cb + 2*half]
and y[t, p*cb + half : p*cb + 2*half] = x[t, p*cb : p*cb + half].  The
port's counterpart of the JAX package's ``tools/probe_copy_bw.py``, at its
shape, (12, 320, 72320) bf16 with pp 4, cb 80, half 40 (the L1 shift of the
packed layout):

- direct: ``ops.probes.block_copy`` (the Pallas ``_hbm_kernel``);
- staged: ``ops.probes.block_copy_staged`` over the JAX tool's lane
  tiles, 8 and 16 a frame of 72320 // n rounded down to 128 (the Pallas
  ``_vmem_kernel``; the lanes past n * tile are not written), on the route
  it prints (the TMA at every shape here, which splits by boxes, not by
  tiles);
- ``Tensor.copy_`` of the same slices (three calls), and the JAX tool's
  slice + concat of one channel block (``torch.roll`` and ``torch.cat``).

Then the port's own layout, (T, C, H*W) with pp 1: ``shift_round``'s shape
at T = 4, C = 80, 360x640, and the deblur_plus window's decoder_level1
tensor, T = 40 (1.47 GB each way), direct and staged (the staged kernel's
own tiling).  Every copy is checked bit for bit on the region it writes.
GB/s count each byte read once and written once; the bound is those bytes
at 3.35 TB/s.  Needs a CUDA device.
"""
from __future__ import annotations

import sys

import torch

from shiftnet_tpu_torch.ops import probes
from shiftnet_tpu_torch.tools.timing import (bytes_ms, card, median_ms,
                                             randn_bf16, require_cuda)

JAX_SHAPE = (12, 4, 80, 72320)       # t, pp, cb, lanes
N_TILES = (8, 16)                    # the JAX tool's lane tilings
PORT_SHAPES = ((4, 80, 360 * 640),   # shift_round at T = 4 (chip_smoke)
               (40, 80, 360 * 640))  # decoder_level1 of a 40-frame window


def copy_slices(x: torch.Tensor, y: torch.Tensor, pp: int, half: int,
                lanes: int) -> None:
    """The permutation as three ``Tensor.copy_`` calls on strided views."""
    t = x.shape[0]
    x5 = x.view(t, pp, 2, half, x.shape[2])[..., :lanes]
    y5 = y.view(t, pp, 2, half, y.shape[2])[..., :lanes]
    y5[:, :, 1].copy_(x5[:, :, 0])
    y5[1:, :, 0].copy_(x5[:-1, :, 1])
    y5[0, :, 0].copy_(x5[t - 1, :, 1])


def run_case(label: str, x: torch.Tensor, pp: int, half: int, *,
             staged: bool, lanes: int | None = None,
             tile: int | None = None) -> dict:
    """One copy of the permutation: checked, timed, and timed beside the
    same slices' ``Tensor.copy_``."""
    t, rows, width = x.shape
    lanes = width if lanes is None else lanes
    pieces = probes.shift_pieces(t, pp, rows // pp, half)
    if staged:
        def run():
            return probes.block_copy_staged(x, x.shape, pieces, lanes,
                                            tile=tile)
    else:
        def run():
            return probes.block_copy(x, x.shape, pieces, lanes)
    route = f' route {probes.staged_route(x, x.shape)}' if staged else ''
    want = probes.block_copy_plain(x, x.shape, pieces, lanes)
    ok = torch.equal(probes.written(run(), pieces, lanes),
                     probes.written(want, pieces, lanes))
    del want
    ms = median_ms(run)
    y = torch.empty_like(x)
    lib_ms = median_ms(lambda: copy_slices(x, y, pp, half, lanes))
    nbytes = 2 * len(pieces) * half * lanes * x.element_size()
    bound = bytes_ms(nbytes)
    print(f'{label}: {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s r+w, '
          f'{100 * bound / ms:.0f} % of the {bound:.3f} ms bound) | '
          f'Tensor.copy_ {lib_ms:.3f} ms ({nbytes / lib_ms / 1e6:.0f} GB/s)'
          f'{route} {"OK bit-exact" if ok else "FAIL"}', flush=True)
    return dict(ms=ms, library_ms=lib_ms, bound_ms=bound, ok=ok)


def jax_shape() -> bool:
    t, pp, cb, lp = JAX_SHAPE
    half = cb // 2
    x = randn_bf16((t, pp * cb, lp), 0)
    ok = run_case('direct (frame x block pieces)', x, pp, half,
                  staged=False)['ok']
    for n_tiles in N_TILES:
        tl = lp // n_tiles
        tl -= tl % 128
        ok &= run_case(f'staged ({n_tiles} lane tiles of {tl})', x, pp, half,
                       staged=True, lanes=n_tiles * tl, tile=tl)['ok']
    cat = lambda v: torch.cat(  # noqa: E731
        [torch.roll(v, 1, 0)[:, half:2 * half], v[:, :half]], 1)
    ms = median_ms(lambda: cat(x))
    nbytes = 2 * t * cb * lp * x.element_size()
    print(f'torch roll + slice + cat (one block): {ms:.3f} ms '
          f'({nbytes / ms / 1e6:.0f} GB/s r+w of its output)', flush=True)
    return ok


def port_shapes() -> bool:
    ok = True
    for t, c, hw in PORT_SHAPES:
        x = randn_bf16((t, c, hw), 1)
        for staged in (False, True):
            ok &= run_case(f'{"staged" if staged else "direct"} ({t}, {c}, '
                           f'{hw}) pp 1', x, 1, c // 2, staged=staged)['ok']
        del x
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    require_cuda('probe_copy_bw')
    print(card())
    ok = jax_shape()
    ok &= port_shapes()
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
