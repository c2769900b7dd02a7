"""Probe: copies from a row offset, and from a byte offset that is not
16-byte aligned.

  python -m shiftnet_tpu_torch.tools.probe_dma_align

The port's counterpart of the JAX package's ``tools/probe_dma_align.py``.
There the question was whether Mosaic takes a sublane offset of 40 or 8
rows; here a 2 KB row of (128, 1024) bf16 keeps every row offset 16-byte
aligned, so the probes add the Hopper form of the question, a source 6
bytes past a 16-byte boundary on every row:

- ``out = x[off:off + 48]`` staged through shared memory
  (``ops.probes.block_copy_staged``, the Pallas ``_dma_off_kernel``), at
  off 40 and 8, and at off 40 with lanes 3 .. 1019: on the TMA, whose
  tensor map takes the source row and lane as element coordinates, so
  neither needs rounding (the route is printed);
- ``out = x[off:off + 40]`` copied directly (``ops.probes.block_copy``,
  the Pallas ``_slice_kernel``), the same offsets.

Each prints OK and the error against the reference, and its time; exits 1
on any mismatch.  Needs a CUDA device.
"""
from __future__ import annotations

import sys

import torch

from shiftnet_tpu_torch.ops import probes
from shiftnet_tpu_torch.tools.timing import (card, median_ms, randn_bf16,
                                             require_cuda)

M = 1024
LANE_OFF = 3  # 6 bytes: no cp.async width fits
CASES = ((40, 0), (8, 0), (40, LANE_OFF))  # (row offset, lane offset)


def _probe(label: str, copy, seed: int, off: int, rows: int,
           lane: int) -> bool:
    x = randn_bf16((1, 128, M), seed)
    lanes = M - 8 if lane else M
    pieces = [(0, off, 0, 0, rows)]
    route = (f' route {probes.staged_route(x, (1, rows, lanes))}'
             if copy is probes.block_copy_staged else '')

    def run():
        return copy(x, (1, rows, lanes), pieces, lanes, src_lane=lane)
    got = run()[0].float()
    err = float((got - x[0, off:off + rows, lane:lane + lanes].float())
                .abs().max())
    ms = median_ms(run)
    where = f'{off}' + (f', lane {lane} ({2 * lane} B)' if lane else '')
    print(f'{label} offset {where} (bfloat16):{route} '
          f'{"OK" if err == 0.0 else "FAIL"} err={err}  {1e3 * ms:.2f} us',
          flush=True)
    return err == 0.0


def probe_dma_offset(off: int, rows: int = 48, lane: int = 0) -> bool:
    return _probe('staged row', probes.block_copy_staged, 0, off, rows, lane)


def probe_value_slice(off: int, rows: int = 40, lane: int = 0) -> bool:
    return _probe('direct slice', probes.block_copy, 1, off, rows, lane)


def main() -> int:
    require_cuda('probe_dma_align')
    print(card())
    ok = True
    for probe in (probe_dma_offset, probe_value_slice):
        for off, lane in CASES:
            ok &= probe(off, lane=lane)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
