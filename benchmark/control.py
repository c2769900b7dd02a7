"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one step below the
configuration's precision (``reference/precision.CONTROLS``: fp8 for
bfloat16, TF32 for float32), and, for training cells, faults planted in
it; each held to the float32 reference by the cell's own comparison, at
the cell's own size.  The benchmark's runs do not run this; it reads the
upper ends from which the limits are set (PERF.md).

  python -m benchmark.control --workload <name> --seeds 1 2 3 \\
      [--fault half_batch|altered|stage_lost | --program]

``--program`` (training cells) reads the program's own numbers instead,
seed after seed in one process: the set-up's first steps and the check,
without the window.  Prints one JSON line a seed: the numbers compared
and the limits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import generator, harness, manifest
from benchmark.reference.precision import CONTROLS


def control(cell: manifest.Cell, seed: int, device,
            fault: str | None = None,
            program: bool = False) -> dict[str, float]:
    kind = cell.traffic['kind']
    if kind == 'restore':
        from benchmark.restore import Restore
        drv = Restore(cell, seed, device, None, program=False)
        quant, tf32 = CONTROLS[cell.config['precision']['restore']]
        clip = generator.derive(seed, 'check') % len(drv.pool)
        return drv.check(quant=quant, tf32=tf32, clip=clip)
    from benchmark.train import Train
    if program:
        drv = Train(cell, seed, device, None)
        drv.release()
        harness.free(device)
        return drv.check()
    drv = Train(cell, seed, device, None, program=False)
    quant, tf32 = CONTROLS[cell.config['precision']['train']]
    if fault:
        return drv.check(control=True, fault=fault)
    return drv.check(control=True, quant=quant, tf32=tf32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='benchmark.control')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--fault', choices=('half_batch', 'altered',
                                        'stage_lost'))
    ap.add_argument('--program', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log('benchmark.control: no CUDA card')
        return 2
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t0 = time.time()
        got = control(cell, seed, 'cuda', args.fault, args.program)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'control': ('program' if args.program else
                                      args.fault or 'precision'),
                          'compared': got, 'limits': cell.limits,
                          'seconds': time.time() - t0}), flush=True)
        harness.free('cuda')
    return 0


if __name__ == '__main__':
    sys.exit(main())
