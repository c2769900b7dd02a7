"""Where the time and the memory of one train step go.

Counterpart of the root ``tools/profile_train.py``.  For deblur_plus at
B = 1, T frames, patch x patch, bf16 compute and float32 parameters (the
setup of ``tools/bench_train.py``), fused (the kernels forward) or unfused
(plain autograd), times

- the forward with autograd recording, to the L1 loss over the center
  slice (what a step runs before its backward),
- the forward and the backward,
- the full train step (the forward, the backward and the AdamW update with
  its clip),

each the median of ``--iters`` calls fenced by ``torch.cuda.synchronize()``
after one untimed call, with the peak device memory of each phase; then
the backward's cost (forward+backward - forward) and the optimizer and
loss glue (step - forward+backward), as the JAX tool prints them; then one
full step under ``torch.profiler``: the device's busy share of its wall
time, the port kernels' share of the kernel time, the top kernels.  The
host's load and the card's clocks are printed beside each phase.

  python -m shiftnet_tpu_torch.tools.profile_train [fused|unfused|both] \\
      [T] [patch] [--iters 4]

``--device cpu`` runs the phases on the plain versions, without the
profiler's device summary.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from shiftnet_tpu_torch.tools.bench_train import FORMS, setup
from shiftnet_tpu_torch.tools.timing import host_state
from shiftnet_tpu_torch.train.optim import build_loss
from shiftnet_tpu_torch.train.step import train_step


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def timeit(name: str, fn, device, iters: int) -> dict:
    """One untimed call, then the median of ``iters`` fenced calls, with
    the peak device bytes over all of them."""
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    fn()
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    rec = {'s': statistics.median(times), 'calls_s': times,
           'peak': torch.cuda.max_memory_allocated(device) if cuda else None,
           'host': host_state()}
    peak = 'n/a' if rec['peak'] is None else f'{rec["peak"] / 1e9:.3f} GB'
    print(f'  {name}: {rec["s"] * 1e3:.1f} ms (median of '
          f'{", ".join(f"{v * 1e3:.1f}" for v in times)}); peak {peak}; '
          f'{rec["host"]}', flush=True)
    return rec


def profile(fused: bool, t: int, patch: int, *, iters: int = 4,
            device='cuda') -> dict:
    name = 'fused' if fused else 'unfused'
    print(f'--- {name} (T={t}, {patch}x{patch}) ---', flush=True)
    model, task, opt, batch = setup(fused, t, patch, device)
    fb, ff = task.center_slice
    loss_fn = build_loss(task.loss_spec)
    lq, gt = batch['lq'][0], batch['gt'][0]

    def forward():
        out = model(lq.to(task.dtype))
        return loss_fn(out.float(), gt[fb:t - ff])

    def forward_backward():
        opt.zero_grad(set_to_none=True)
        forward().backward()

    def step():
        return train_step(model, opt, task, batch, None)

    rec = {'form': name, 't': t, 'patch': patch,
           'forward': timeit('forward (autograd recording)', forward, device,
                             iters),
           'forward_backward': timeit('forward+backward', forward_backward,
                                      device, iters),
           'step': timeit('full train step', step, device, iters)}
    fwd, grad, full = (rec[k]['s'] for k in ('forward', 'forward_backward',
                                             'step'))
    rec.update(backward_s=grad - fwd, glue_s=full - grad)
    print(f'  backward cost: {(grad - fwd) * 1e3:.1f} ms '
          f'({grad / max(fwd, 1e-9):.2f}x fwd); optimizer+loss glue: '
          f'{(full - grad) * 1e3:.1f} ms', flush=True)
    if torch.device(device).type == 'cuda':
        from shiftnet_tpu_torch.tools.profile_forward import traced
        print('  one full step under torch.profiler:', flush=True)
        rec['trace'] = traced(step)
    del model, opt, batch
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('which', nargs='?', default='both',
                    choices=['fused', 'unfused', 'both'])
    ap.add_argument('t', nargs='?', type=int, default=16)
    ap.add_argument('patch', nargs='?', type=int, default=256)
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    forms = ['unfused', 'fused'] if args.which == 'both' else [args.which]
    if torch.device(args.device).type == 'cuda':
        from shiftnet_tpu_torch.tools.timing import card
        print(card(), flush=True)
    return {form: profile(FORMS[form], args.t, args.patch, iters=args.iters,
                          device=args.device) for form in forms}


if __name__ == '__main__':
    main()
