"""Probe: a device-memory to device-memory copy with a dynamic source frame
and a 40-row offset, the access pattern of the temporal half-channel shift.

  python -m shiftnet_tpu_torch.tools.probe_hbm_copy

The port's counterpart of the JAX package's ``tools/probe_hbm_copy.py``:
x (4, 128, 1024) bf16, and o[t, 40:80] = x[max(t - 1, 0), 40:80] through
``ops.probes.block_copy`` (direct, no shared memory).  The other rows of o
are never written and are not compared.  Prints OK and the error against
the reference, and the copy's time; exits 1 on a mismatch.  Needs a CUDA
device.
"""
from __future__ import annotations

import sys

import torch

from shiftnet_tpu_torch.ops import probes
from shiftnet_tpu_torch.tools.timing import (bytes_ms, card, median_ms,
                                             randn_bf16, require_cuda)

ROW0 = 40


def probe(t: int = 4, rows: int = 40, c: int = 128, m: int = 1024) -> bool:
    x = randn_bf16((t, c, m), 0)
    pieces = probes.hbm_copy_pieces(t, ROW0, rows)

    def run():
        return probes.block_copy(x, x.shape, pieces, m)
    got = probes.written(run(), pieces, m).float()
    ref = torch.cat([x[max(ti - 1, 0), ROW0:ROW0 + rows].flatten()
                     for ti in range(t)]).float()
    err = float((got - ref).abs().max())
    ms = median_ms(run)
    nbytes = 2 * t * rows * m * 2
    print(f'block_copy (dyn frame, row off {ROW0}): '
          f'{"OK" if err == 0.0 else "FAIL"} err={err}  {1e3 * ms:.2f} us '
          f'({nbytes / ms / 1e6:.1f} GB/s r+w, bound '
          f'{1e3 * bytes_ms(nbytes):.2f} us)', flush=True)
    return err == 0.0


def main() -> int:
    require_cuda('probe_hbm_copy')
    print(card())
    return 0 if probe() else 1


if __name__ == '__main__':
    sys.exit(main())
