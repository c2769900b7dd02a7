#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shiftnet_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit, torch and CUDA versions.  There
   is no CPU path: without a CUDA device the run fails.
2. build: compile the four CUDA kernels from ``shiftnet_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version on seeded inputs
   at the shapes of the 720p deblur_plus window (T = 4), in float32 (TF32
   off) and bfloat16, with median times over 20 runs.
4. slice: the port's ``Evaluator('deblur_plus')`` on a seeded 40x720x1280
   bf16 window through ``forward_window``, with every kernel launched; then
   the whole model with its TFR U-Nets on the kernels against the same model
   on the plain versions, on a 5x720x1280 float32 window.

The line before the last is a JSON object with each kernel's launches on the
main path, its error and its times; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises before that line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Normalized max error max|kernel - plain| / std(plain).  float32 differs by
# summation order only.  In bfloat16 the kernels and the plain ops sum in
# different orders in float32, so single-ulp rounding flips land on some of
# the largest of the ~10^8 outputs: one bf16 ulp (2^-7 relative) at
# max|p| ~ 6 std(p) is 0.03-0.05 std(p).  up_skip also rounds at other
# points (its 1x1 conv runs before the upsample).  The normalized mean error
# must stay under half a bf16 ulp, so a systematic error cannot hide under
# the max bound.
TOL = {'float32': 1e-4, 'bfloat16': 5e-2}
MEAN_TOL = {'float32': 1e-6, 'bfloat16': 2 ** -8}
SLICE_TOL_F32 = 1e-3  # whole model: ~150 convs of float32 reordering
T_CHECK = 4
HALO = 2
ONE_LEN = 36
H, W = 720, 1280

KERNELS = {
    'cab_front': ('shiftnet_tpu_torch/csrc/cab_front.cu',
                  'shiftnet_tpu/ops/chw.py:289',
                  'shiftnet_tpu/ops/chw.py:654'),
    'cab_back': ('shiftnet_tpu_torch/csrc/cab_back.cu',
                 'shiftnet_tpu/ops/chw.py:378', None),
    'conv': ('shiftnet_tpu_torch/csrc/conv.cu',
             'shiftnet_tpu/ops/chw.py:865', None),
    'up_skip': ('shiftnet_tpu_torch/csrc/up_skip.cu',
                'shiftnet_tpu/ops/chw.py:1195', None),
}


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port has no CPU '
                         'path to smoke-test')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} '
          f'count {torch.cuda.device_count()}', flush=True)
    return card


def build_phase():
    from shiftnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.library()
    dt = time.perf_counter() - t0
    print(f'build: {path.name} ready in {dt:.2f} s', flush=True)
    return dt


def _median_ms(fn, n=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _norm_err(k, p):
    """(normalized max error, normalized mean error, max abs error)."""
    d = (k.double() - p.double()).abs()
    sd = p.double().std()
    return (float(d.max() / sd), float(d.mean() / sd), float(d.max()))


def _cases():
    """(kernel, label, make(rng, dtype) -> (kernel_fn, plain_fn))."""
    import torch
    from shiftnet_tpu_torch.ops import chw

    def arr(rng, shape, dtype, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(
            'cuda', dtype)

    def wgt(rng, shape, dtype):
        bound = 1.0 / np.sqrt(np.prod(shape[1:]))
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(
            np.float32)).to('cuda', dtype)

    def f32(rng, shape, scale):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()

    cases = []
    for c, h, w in ((24, H, W), (36, H // 2, W // 2), (48, H // 4, W // 4)):
        def front(rng, dt, c=c, h=h, w=w):
            x = arr(rng, (T_CHECK, c, h, w), dt)
            w1, w2 = wgt(rng, (c, c, 3, 3), dt), wgt(rng, (c, c, 3, 3), dt)
            alpha = torch.full((1,), 0.25, device='cuda')
            return (lambda: chw.cab_front(x, w1, alpha, w2),
                    lambda: chw.cab_front_plain(x, w1, alpha, w2))

        def back(rng, dt, c=c, h=h, w=w):
            x = arr(rng, (T_CHECK, c, h, w), dt)
            s = arr(rng, (T_CHECK, c, h, w), dt)
            ca = torch.from_numpy(rng.uniform(0, 1, (T_CHECK, c)).astype(
                np.float32)).to('cuda', dt)
            return (lambda: chw.cab_back(x, s, ca),
                    lambda: chw.cab_back_plain(x, s, ca))
        cases.append(('cab_front', f'C={c} {h}x{w}', front))
        cases.append(('cab_back', f'C={c} {h}x{w}', back))

    conv_shapes = (  # cin, cout, k, stride, bias, prelu, h, w
        (24, 36, 3, 2, True, False, H, W),
        (36, 48, 3, 2, True, False, H // 2, W // 2),
        (24, 24, 3, 1, False, True, H // 2, W // 2),
        (24, 3, 5, 1, False, False, H, W),
    )
    for cin, cout, k, st, bias, pre, h, w in conv_shapes:
        def cv(rng, dt, cin=cin, cout=cout, k=k, st=st, bias=bias, pre=pre,
               h=h, w=w):
            x = arr(rng, (T_CHECK, cin, h, w), dt)
            wt = wgt(rng, (cout, cin, k, k), dt)
            b = f32(rng, (cout,), 0.01) if bias else None
            a = torch.full((1,), 0.25, device='cuda') if pre else None
            return (lambda: chw.conv(x, wt, b, a, st),
                    lambda: chw.conv_plain(x, wt, b, a, st))
        cases.append(('conv', f'{cin}->{cout} k{k} s{st}'
                      f'{" bias" if bias else ""}{" prelu" if pre else ""}'
                      f' {h}x{w}', cv))

    for cin, cout, h, w in ((48, 36, H // 4, W // 4),
                            (36, 24, H // 2, W // 2)):
        def up(rng, dt, cin=cin, cout=cout, h=h, w=w):
            x = arr(rng, (T_CHECK, cin, h, w), dt)
            w11 = wgt(rng, (cout, cin, 1, 1), dt)
            skip = arr(rng, (T_CHECK, cout, 2 * h, 2 * w), dt)
            return (lambda: chw.up_skip(x, w11, skip),
                    lambda: chw.up_skip_plain(x, w11, skip))
        cases.append(('up_skip', f'{cin}->{cout} {h}x{w}->{2 * h}x{2 * w}',
                      up))
    return cases


def kernel_phase(card):
    """Each kernel against its plain version; returns per-kernel records."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'kernels: normalized max error tolerance {TOL}, normalized mean '
          f'error tolerance {MEAN_TOL}', flush=True)
    rec = {name: {'max_abs_err': 0.0, 'ms': None, 'plain_ms': None}
           for name in KERNELS}
    failed = []
    for i, (name, label, make) in enumerate(_cases()):
        for dtn in ('float32', 'bfloat16'):
            dt = getattr(torch, dtn)
            rng = np.random.default_rng(1000 + i)
            kfn, pfn = make(rng, dt)
            with torch.inference_mode():
                k_out, p_out = kfn(), pfn()
                torch.cuda.synchronize()
                if isinstance(k_out, tuple):  # cab_front: (s, sums)
                    errs = [_norm_err(a, b) for a, b in zip(k_out, p_out)]
                else:
                    errs = [_norm_err(k_out, p_out)]
                err = max(e[0] for e in errs)
                mean_err = max(e[1] for e in errs)
                abs_err = max(e[2] for e in errs)
                ms = _median_ms(kfn)
                pms = _median_ms(pfn)
            ok = err <= TOL[dtn] and mean_err <= MEAN_TOL[dtn]
            print(f'kernel {name:9s} {label:34s} {dtn:8s} err {err:.3e} '
                  f'mean {mean_err:.2e} {"ok" if ok else "FAIL"}  kernel '
                  f'{ms:.3f} ms  plain {pms:.3f} ms  [{card}]', flush=True)
            if not ok:
                failed.append(f'{name} {label} {dtn}')
            r = rec[name]
            if dtn == 'bfloat16':
                r['max_abs_err'] = max(r['max_abs_err'], abs_err)
                if r['ms'] is None:  # first case: the largest main-path shape
                    r['ms'], r['plain_ms'] = ms, pms
            del kfn, pfn, k_out, p_out
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f'kernels disagree with their plain versions: '
                             f'{failed}')
    return rec


def _clip(t, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (t, H, W, 3)).astype(np.float32)


def slice_phase(card, logs):
    """deblur_plus windows through the port's Evaluator (logs under
    ``logs``); returns the kernel launches of the main-path run."""
    import torch
    from shiftnet_tpu_torch.eval.runner import Evaluator
    from shiftnet_tpu_torch.models import build_model, init_state
    from shiftnet_tpu_torch.ops import chw

    state = init_state(build_model('deblur_plus'), seed=0)
    ev = Evaluator('deblur_plus', state, device='cuda', result_path=logs)
    t = ONE_LEN + 2 * HALO
    clip = _clip(t, seed=1)
    plan = ev.window_plan(clip.shape)
    print(f'slice: window {clip.shape} plan {plan}', flush=True)

    torch.cuda.reset_peak_memory_stats()
    chw.reset_launches()
    out = ev.forward_window(clip)
    launches = dict(chw.LAUNCHES)
    print(f'slice: main-path launches {launches}', flush=True)
    if out.shape != (ONE_LEN, H, W, 3):
        raise AssertionError(f'output shape {out.shape}')
    if not np.isfinite(out).all():
        raise AssertionError('non-finite output')
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f'kernels not launched on the main path: '
                             f'{missing}')
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ev.forward_window(clip)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    fps = 3 * ONE_LEN / sum(times)
    print(f'slice: deblur_plus 720p bf16 window T={t} plan {plan}: '
          f'{fps:.4f} fps (windows {", ".join(f"{s:.3f}" for s in times)} s)'
          f' peak {peak / 1e9:.3f} GB [{card}]', flush=True)
    del ev, out
    torch.cuda.empty_cache()

    # Kernel TFR vs plain TFR, whole model, one output frame at 720p.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = _clip(2 * HALO + 1, seed=2)
    res = {}
    for dtn in ('float32', 'bfloat16'):
        outs = []
        for fused in (True, False):
            ev = Evaluator('deblur_plus', state, device='cuda',
                           bf16=dtn == 'bfloat16',
                           overrides={'fused_tfr': fused},
                           result_path=logs)
            outs.append(torch.from_numpy(ev.forward_window(small)))
            del ev
            torch.cuda.empty_cache()
        res[dtn] = _norm_err(*outs)[0]
    print(f'slice: kernel TFR vs plain TFR, 5x{H}x{W}: float32 err '
          f'{res["float32"]:.3e} (tol {SLICE_TOL_F32:.0e}), bfloat16 err '
          f'{res["bfloat16"]:.3e}', flush=True)
    if not res['float32'] <= SLICE_TOL_F32:
        raise AssertionError('kernel slice disagrees with the plain slice')
    return launches


def main():
    card = device_phase()
    build_phase()
    import torch
    rec = kernel_phase(card)
    with tempfile.TemporaryDirectory() as logs:
        launches = slice_phase(card, logs)
    kernels = []
    for name, (src, repl, also) in KERNELS.items():
        entry = {'name': name, 'route': 'cuda', 'source': src,
                 'replaces': repl, 'launches': launches[name],
                 'max_abs_err': rec[name]['max_abs_err'],
                 'ms': rec[name]['ms'], 'plain_ms': rec[name]['plain_ms']}
        if also:
            entry['also_replaces'] = also
        kernels.append(entry)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
