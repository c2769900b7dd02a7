"""Cycles per phase of the ``naf_gate``, ``naf_rep`` and ``conv_cat``
kernels' blocks.

  python -m shiftnet_tpu_torch.tools.phase_naf [--f32]

Builds the kernels with ``-DSHIFTNET_PHASES`` (a library of its own: the
build is keyed on the flags), in which thread 0 of each block adds the
``clock64()`` cycles between the kernels' phase barriers
(``csrc/conv_core.cuh``, ``SHIFTNET_PHASE``), then runs each naf and
conv_cat case of ``tools/bench_conv.py`` at every output tile that fits and
prints the mean cycles per tile and phase.  Each mark adds a barrier, so
the phases sum to a little more than a plain build's time.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes

import torch

from shiftnet_tpu_torch.ops import _build, chw, naf_chw
from shiftnet_tpu_torch.tools import bench_conv
from shiftnet_tpu_torch.tools.timing import card, require_cuda

RUNS = 5
GATE_PHASES = ('staging', 'hw2', 'LN', 'expand', 'RepConv2+gate',
               'stores+sums')
REP_PHASES = ('staging', '5x5', 'expand+gate', 'stores+sums')
CAT_PHASES = ('staging', 'products+epilogue')


def _phases(lib, name: str, fn, jobs: int, labels) -> str:
    read = getattr(lib, f'shiftnet_{name}_phases')
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    buf = (ctypes.c_ulonglong * 16)()
    fn()
    torch.cuda.synchronize()
    _build.check(read(buf), name)  # clear the warm-up's cycles
    for _ in range(RUNS):
        fn()
    torch.cuda.synchronize()
    _build.check(read(buf), name)
    per = [buf[i] / RUNS / jobs for i in range(len(labels))]
    return ' '.join(f'{k}={v:.0f}' for k, v in zip(labels, per)) + (
        f' total={sum(per):.0f} cycles/tile')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--f32', action='store_true',
                    help='also the float32 forms')
    args = ap.parse_args(argv)
    require_cuda('phase_naf')
    _build.NVCC_FLAGS.append('-DSHIFTNET_PHASES')
    lib = _build.library()
    t = bench_conv.T
    print(f'phase_naf: T={t}, {card()}, torch {torch.__version__}',
          flush=True)
    dtypes = (torch.bfloat16,) + ((torch.float32,) if args.f32 else ())
    with torch.inference_mode():
        for dt in dtypes:
            size = torch.tensor([], dtype=dt).element_size()
            for i, (n, cab2, h, w) in enumerate(bench_conv.GATE_SHAPES):
                prep = bench_conv._naf_prep(n, cab2, n == 64, dt, 300 + i)
                add_c = n // 2 if cab2 else 0
                y = bench_conv._randn((t, n, h, w), 400 + i, dt)
                hw = (bench_conv._randn((t, add_c, h, w), 500 + i, dt)
                      if cab2 else None)
                for tile in naf_chw.TILES:
                    if naf_chw.naf_gate_smem(n, add_c, size,
                                             *tile) > naf_chw.SMEM_BYTES:
                        continue
                    jobs = t * -(-h // tile[0]) * -(-w // tile[1])
                    print(f'naf_gate {"CAB2" if cab2 else "CAB1"} n={n} '
                          f'{h}x{w} {str(dt)[6:]} {tile[0]}x{tile[1]}: '
                          + _phases(lib, 'naf_gate', lambda: naf_chw.naf_gate(
                              y, hw, prep, tile=tile), jobs, GATE_PHASES),
                          flush=True)
            for i, (n, dw, opts, h, w) in enumerate(bench_conv.REP_SHAPES):
                prep = bench_conv._naf_prep(n, True, dw, dt, 600 + i)
                g = bench_conv._randn((t, n, h, w), 700 + i, dt)
                cag = (torch.rand((t, n), device='cuda').to(dt) if opts
                       else None)
                group = 1 if dw else 8
                for tile in naf_chw.TILES:
                    if naf_chw.naf_rep_smem(n, size, *tile,
                                            group) > naf_chw.SMEM_BYTES:
                        continue
                    jobs = t * -(-h // tile[0]) * -(-w // tile[1])
                    print(f'naf_rep{" depthwise" if dw else ""} n={n} '
                          f'{h}x{w}{" cag" if opts else ""} {str(dt)[6:]} '
                          f'{tile[0]}x{tile[1]}: '
                          + _phases(lib, 'naf_rep', lambda: naf_chw.naf_rep(
                              g, cag, prep, tile=tile), jobs, REP_PHASES),
                          flush=True)
            for i, (n_in, c, bias, pre, h, w) in enumerate(
                    bench_conv.CAT_SHAPES):
                xs = [bench_conv._randn((t, c, h, w), 1400 + 3 * i + s, dt)
                      for s in range(n_in)]
                with torch.inference_mode(False):  # its panels kept
                    wt = bench_conv._randn((c, n_in * c, 3, 3), 1500 + i,
                                           dt, (9 * n_in * c) ** -0.5)
                b = torch.zeros(c, device='cuda') if bias else None
                a = torch.full((1,), 0.25, device='cuda') if pre else None
                for tile in chw.CONV_TILES:
                    if chw.conv_cat_smem(n_in, c, c, size,
                                         *tile) > chw.SMEM_BYTES:
                        continue
                    jobs = t * -(-h // tile[0]) * -(-w // tile[1])
                    print(f'conv_cat {n_in}x{c}->{c} {h}x{w} {str(dt)[6:]} '
                          f'{tile[0]}x{tile[1]}: '
                          + _phases(lib, 'conv_cat',
                                    lambda: chw.conv_concat(xs, wt, b, a,
                                                            tile=tile),
                                    jobs, CAT_PHASES), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
