"""Train-step benchmark of the port: fused (the kernels forward) against
unfused (plain autograd).

Counterpart of the root ``tools/bench_train.py``.  Times one deblur_plus
train step (``train/step.train_step``): B = 1 clip of T frames at
patch x patch, bf16 compute, float32 parameters, L1 over the center slice
(1, 1), AdamW with global-norm clip 0.01, on a seeded batch made on the
device (no loader).  The first ``--warmup`` steps are timed apart; then
``--steps`` steps, each fenced by ``torch.cuda.synchronize()``.  Each form
prints its s/step (median of the timed steps, and each step), its peak
device memory and loss, with the host's load and the card's clocks
(``timing.host_state``) before and after.

  python -m shiftnet_tpu_torch.tools.bench_train [fused|unfused|both] \\
      [T] [patch] [--steps 5] [--warmup 1] [--largest {t,patch}]

``--largest t`` (at ``patch``) or ``--largest patch`` (at ``T``, in steps
of 64) finds the largest clip whose step fits the card's memory for each
form: it extrapolates the peaks of two smaller steps, then runs single
steps up from just under the estimate until one runs out of memory.
``--device cpu`` runs the steps on the plain versions (no timing claims).
"""
from __future__ import annotations

import argparse
import gc
import statistics
import time

import torch

from shiftnet_tpu_torch.models import build_model, init_params
from shiftnet_tpu_torch.tools.timing import host_state
from shiftnet_tpu_torch.train.optim import OptimConfig, build_optimizer
from shiftnet_tpu_torch.train.step import TaskConfig, train_step

FORMS = {'unfused': False, 'fused': True}


def setup(fused: bool, t: int, patch: int, device):
    """deblur_plus (seeded weights), its task, AdamW and a seeded batch
    made on ``device``, as the JAX tool sets them up."""
    model = build_model('deblur_plus', fused_chw=fused)
    init_params(model, 0)
    model.to(device)
    task = TaskConfig(kind='deblur', loss_spec='1*L1', center_slice=(1, 1),
                      dtype=torch.bfloat16)
    opt = build_optimizer(model, OptimConfig(total_iters=1000,
                                             grad_clip=0.01))
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {k: torch.rand((1, t, 3, patch, patch), generator=gen,
                           device=device) for k in ('lq', 'gt')}
    return model, task, opt, batch


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def bench(fused: bool, t: int, patch: int, *, steps: int = 5,
          warmup: int = 1, device='cuda', quiet: bool = False) -> dict:
    """One form's numbers: the warm-up steps' and the timed steps'
    seconds, their median, the peak device bytes (None on the CPU), the
    last loss and the host state before and after."""
    name = 'fused' if fused else 'unfused'
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model, task, opt, batch = setup(fused, t, patch, device)
    before = host_state()
    times = []
    for _ in range(warmup + steps):
        _sync(device)
        t0 = time.perf_counter()
        metrics = train_step(model, opt, task, batch, None)
        _sync(device)
        times.append(time.perf_counter() - t0)
    loss = float(metrics['loss'])
    rec = {'form': name, 't': t, 'patch': patch,
           'first_s': times[:warmup], 'steps_s': times[warmup:],
           'median_s': statistics.median(times[warmup:]) if steps else None,
           'peak': torch.cuda.max_memory_allocated(device) if cuda else None,
           'loss': loss, 'host_before': before, 'host_after': host_state()}
    if not quiet:
        peak = 'n/a' if rec['peak'] is None else f'{rec["peak"] / 1e9:.3f} GB'
        med = 'n/a' if rec['median_s'] is None else f'{rec["median_s"]:.4f}'
        print(f'bench_train: {name} T={t} {patch}x{patch}: first '
              f'{", ".join(f"{v:.4f}" for v in rec["first_s"])} s; '
              f'{med} s/step (median of {steps}: '
              f'{", ".join(f"{v:.4f}" for v in rec["steps_s"])}); peak '
              f'{peak}; loss {loss:.5f}\n  host before: {before}\n  host '
              f'after: {rec["host_after"]}', flush=True)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f'{name}: non-finite loss {loss}')
    del model, opt, batch
    return rec


def fits(fused: bool, t: int, patch: int, device='cuda') -> int | None:
    """The peak bytes of one step at (t, patch), or None if it runs out of
    device memory."""
    try:
        return bench(fused, t, patch, steps=0, warmup=1, device=device,
                     quiet=True)['peak']
    except torch.OutOfMemoryError:
        return None
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def largest(fused: bool, axis: str, t: int, patch: int,
            device='cuda') -> dict:
    """The largest T (``axis='t'``, at ``patch``) or patch (``'patch'``, at
    ``t``, multiples of 64) whose step fits: the peak of two small steps
    extrapolated (linear in T, in patch squared), then single steps from
    just under the estimate up to the first that runs out of memory."""
    total = torch.cuda.get_device_properties(device).total_memory
    if axis == 't':
        sizes, key, unit = (4, 8), lambda v: v, 1
    else:
        sizes, key, unit = (128, 256), lambda v: v * v, 64
    peaks = [fits(fused, *((v, patch) if axis == 't' else (t, v)), device)
             for v in sizes]
    if None in peaks:
        raise AssertionError(f'largest: a step at {sizes} does not fit')
    slope = (peaks[1] - peaks[0]) / (key(sizes[1]) - key(sizes[0]))

    def est(v):
        return peaks[0] + slope * (key(v) - key(sizes[0]))
    v = sizes[1]
    while est(v + unit) < total:
        v += unit
    v = max(sizes[1], v - unit)  # start just under the estimate
    tried = {}
    while True:
        args = (v, patch) if axis == 't' else (t, v)
        tried[v] = fits(fused, *args, device)
        got = ('out of memory' if tried[v] is None else
               f'peak {tried[v] / 1e9:.3f} GB (estimate {est(v) / 1e9:.3f})')
        print(f'largest {axis}: {"fused" if fused else "unfused"} '
              f'{args}: {got}', flush=True)
        if tried[v] is None:
            if v - unit in tried or v - unit < sizes[1]:
                break
            v -= unit
        elif v + unit in tried:
            break
        else:
            v += unit
    best = max((k for k, p in tried.items() if p is not None), default=None)
    return {'axis': axis, 'form': 'fused' if fused else 'unfused',
            'largest': best, 'peak': tried.get(best), 'card_bytes': total,
            'small_peaks': dict(zip(sizes, peaks))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('which', nargs='?', default='both',
                    choices=['fused', 'unfused', 'both'])
    ap.add_argument('t', nargs='?', type=int, default=16)
    ap.add_argument('patch', nargs='?', type=int, default=256)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--warmup', type=int, default=1)
    ap.add_argument('--largest', choices=['t', 'patch'], default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    forms = ['unfused', 'fused'] if args.which == 'both' else [args.which]
    if torch.device(args.device).type == 'cuda':
        from shiftnet_tpu_torch.tools.timing import card
        print(card(), flush=True)
    out = {}
    for form in forms:
        if args.largest:
            out[form] = largest(FORMS[form], args.largest, args.t,
                                args.patch, args.device)
            print(f'bench_train: {form} largest {args.largest}: '
                  f'{out[form]["largest"]}', flush=True)
        else:
            out[form] = bench(FORMS[form], args.t, args.patch,
                              steps=args.steps, warmup=args.warmup,
                              device=args.device)
    if args.which == 'both' and not args.largest and args.steps:
        print(f'bench_train: fused / unfused s/step '
              f'{out["fused"]["median_s"] / out["unfused"]["median_s"]:.3f}')
    return out


if __name__ == '__main__':
    main()
