"""Probe: the cost of a kernel parameter at launch, on the smallest copy.

  python -m shiftnet_tpu_torch.tools.probe_launch

The bytes of ``tools/probe_dma_align.py``'s direct slice (40 rows of a
(128, 1024) bf16 array, 80 KB) copied by a minimal kernel, one 16-byte
unit a thread, launched without and with the 3 KB piece table that the
staged copies pass as an unused parameter (``ops.probes.param_probe``);
beside ``Tensor.copy_`` and ``ops.probes.block_copy`` of the same slice.
Each is timed as every probe is (``timing.median_ms``, host time hidden),
in turns forward and backward, four rounds.  Needs a CUDA device.
"""
from __future__ import annotations

import sys

import torch

from shiftnet_tpu_torch.ops import probes
from shiftnet_tpu_torch.tools.timing import (card, median_ms, randn_bf16,
                                             require_cuda)

ROUNDS = 4


def main() -> int:
    require_cuda('probe_launch')
    print(card())
    x = randn_bf16((1, 128, 1024), 6)
    y = x.new_empty((40, 1024))
    src = x[0, 40:80]
    runs = [
        ('Tensor.copy_', lambda: y.copy_(src)),
        ('minimal kernel', lambda: probes.param_probe(src, y, False)),
        ('minimal + 3 KB param', lambda: probes.param_probe(src, y, True)),
        ('block_copy', lambda: probes.block_copy(
            x, (1, 40, 1024), [(0, 40, 0, 0, 40)], 1024))]
    ok = True
    for _, fn in runs[1:3]:
        y.zero_()
        fn()
        ok &= torch.equal(y, src)
    times = {name: [] for name, _ in runs}
    for r in range(ROUNDS):
        for name, fn in (runs if r % 2 == 0 else runs[::-1]):
            times[name].append(1e3 * median_ms(fn))
    for name, ts in times.items():
        print(f'{name:22s} ' + ' '.join(f'{t:.2f}' for t in ts) + ' us',
              flush=True)
    print('minimal kernel copies bit for bit' if ok else 'FAIL', flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
