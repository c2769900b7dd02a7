"""Tensor-core rate of the ``mm_loop`` probe at the model's product shapes,
beside cuBLAS.

  python -m shiftnet_tpu_torch.tools.microbench_mm [--plans]

The port's counterpart of the JAX package's ``tools/microbench_mm.py``: the
same thirteen bf16 shapes (a dense reference, aligned sweeps, the TFR conv1
and s2d products, the Encoder2 expand at c = 80), plus the expand of the
``naf_gate`` kernel at n = 80 and n = 64 with its add_c input, at the
shape ``csrc/naf_gate.cu`` computes it: every pixel of every tile's expand
region (the 16 x 16 tile and its 1-pixel halo) of a T = 4 360x640 tensor.
Each case runs ``ops.probes.mm_loop`` (``iters`` products summed inside one
launch; K filled with zeros to a 64-deep chunk and N to the tile's width,
only the real 2*M*K*N counted), checks
it against its plain version, and prints the time and rate per iteration
beside one ``torch.matmul`` (cuBLAS) of the same product and the 989
TFLOP/s bf16 peak, with the tile ``ops.probes.mm_plan`` chose.  With
``--plans`` it then times, at every case, each tile that fits
(``ops.probes.mm_tile``), the planner's marked.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys

import torch

from shiftnet_tpu_torch.ops import naf_chw, probes
from shiftnet_tpu_torch.tools.timing import (card, median_ms, ops_ms,
                                             rand_bf16, require_cuda)

MM_TOL = 2.0 ** -7   # one bf16 ulp at the largest output, relative to it


def gate_pixels(n: int, add_c: int, t: int = 4, h: int = 360,
                w: int = 640) -> int:
    """Pixels ``naf_gate`` expands over a (t, n, h, w) tensor: each tile's
    expand region, the tile plus a 1-pixel halo."""
    th, tw = naf_chw.naf_gate_tile(n, add_c, 2)
    return t * -(-h // th) * -(-w // tw) * (th + 2) * (tw + 2)


def cases() -> list[tuple[str, int, int, int, int]]:
    """(name, m, k, n, iters): the JAX tool's list, then naf_gate's
    expand."""
    px80, px64 = gate_pixels(80, 40), gate_pixels(64, 32)
    return [
        ('ref  (8192,512)@(512,512)', 8192, 512, 512, 30),
        ('ref  (512,512)@(512,8192)', 512, 512, 8192, 30),
        ('aln  (8192,256)@(256,128)', 8192, 256, 128, 100),
        ('aln  (128,256)@(256,8192)', 128, 256, 8192, 100),
        ('aln  (8192,256)@(256,32)', 8192, 256, 32, 100),
        ('W@P  (24,216)@(216,10240)', 24, 216, 10240, 100),
        ('P@W  (10240,216)@(216,24)', 10240, 216, 24, 100),
        ('P@Wp (10240,216)@(216,128)', 10240, 216, 128, 100),
        ('s2d  (96,384)@(384,5120)', 96, 384, 5120, 100),
        ('s2d  (5120,384)@(384,96)', 5120, 384, 96, 100),
        ('s2d  (5120,384)@(384,128)', 5120, 384, 128, 100),
        ('c80  (10240,80)@(80,160)', 10240, 80, 160, 100),
        ('c80  (10240,80)@(80,128)', 10240, 80, 128, 100),
        (f'gate n=80 ({px80},120)@(120,160)', px80, 120, 160, 30),
        (f'gate n=64 ({px64},96)@(96,128)', px64, 96, 128, 30),
    ]


def mm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|: at most 2^-7 when the two round one
    bf16 ulp apart at the largest output."""
    w = want.double()
    return float((got.double() - w).abs().max() / w.abs().max())


def bench_mm(name: str, m: int, k: int, n: int, iters: int,
             seed: int = 0) -> dict:
    """One case: checked, then timed per iteration (kernel and cuBLAS)."""
    a, b = rand_bf16((m, k), seed), rand_bf16((k, n), seed + 1)
    err = mm_err(probes.mm_loop(a, b, iters), probes.mm_loop_plain(a, b,
                                                                   iters))
    ms = median_ms(lambda: probes.mm_loop(a, b, iters))
    lib_ms = iters * median_ms(lambda: torch.matmul(a, b))
    ops = 2 * m * k * n * iters
    plan = probes.mm_plan(m, k, n)
    rec = dict(name=name, ms=ms, library_ms=lib_ms, bound_ms=ops_ms(ops),
               err=err, ok=err <= MM_TOL)
    print(f'{name:<44s} {1e3 * ms / iters:9.2f} us  '
          f'{ops / ms / 1e9:6.1f} TF/s  | cuBLAS {1e3 * lib_ms / iters:9.2f} '
          f'us {ops / lib_ms / 1e9:6.1f} TF/s | peak '
          f'{1e3 * rec["bound_ms"] / iters:7.2f} us  err {err:.2e} '
          f'{"OK" if rec["ok"] else "FAIL"}  tile {plan.bm}x{plan.bn}',
          flush=True)
    return rec


def bench_plans(name: str, m: int, k: int, n: int, iters: int,
                seed: int = 0) -> bool:
    """Every tile that fits, checked and timed; the planner's marked."""
    a, b = rand_bf16((m, k), seed), rand_bf16((k, n), seed + 1)
    want = probes.mm_loop_plain(a, b, iters)
    chosen = probes.mm_plan(m, k, n)
    cover = min([w for w in probes.MM_WIDTHS if w >= n]
                or [probes.MM_WIDTHS[-1]])
    ops, ok = 2 * m * k * n * iters, True
    for bm in (64, 128):
        for bn in probes.MM_WIDTHS:
            plan = probes.mm_tile(bm, bn, m, k, n)
            if bn > cover or plan.smem > probes.SMEM_BYTES:
                continue
            err = mm_err(probes.mm_loop(a, b, iters, plan=plan), want)
            ok &= err <= MM_TOL
            ms = median_ms(lambda: probes.mm_loop(a, b, iters, plan=plan))
            print(f'{name:<44s} tile {bm:3d}x{bn:<3d} {ms:.4f} ms '
                  f'{ops / ms / 1e9:6.1f} TF/s  err {err:.2e}'
                  f'{"  <- mm_plan" if plan == chosen else ""}', flush=True)
    return ok


def main(argv=()) -> int:
    require_cuda('microbench_mm')
    ap = argparse.ArgumentParser(prog='microbench_mm')
    ap.add_argument('--plans', action='store_true')
    args = ap.parse_args(list(argv))
    print(card())
    print('== mm_loop, wgmma bf16 -> f32 from TMA-loaded panels, per '
          'iteration ==', flush=True)
    recs = [bench_mm(*c) for c in cases()]
    ok = all(r['ok'] for r in recs)
    if args.plans:
        print('== mm_loop tiles ==', flush=True)
        for c in cases():
            ok &= bench_plans(*c)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
