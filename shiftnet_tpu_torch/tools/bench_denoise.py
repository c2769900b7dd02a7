"""Denoise throughput of the port: 480p, sigma 10, one GPU.

  python -m shiftnet_tpu_torch.tools.bench_denoise \\
      [--variant {denoise_plus,denoise_small}] [--bf16] [--one_len N]

The protocol of the JAX package's ``tools/bench_denoise.py``: the variant
(denoise_plus by default) on seeded random weights, a seeded 480x848 clip
of ``one_len`` 12 output frames plus 2+2 halo (T = 16), sigma 10/255,
float32 by default, through the port's ``Evaluator.forward_window`` (the
eval CLI's forward); one warm-up window, then 5 timed windows on the host
clock, fenced by ``torch.cuda.synchronize()``.  Prints the card's name and
power limit, then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from shiftnet_tpu_torch.eval.runner import HALO, Evaluator
from shiftnet_tpu_torch.models import build_model, init_state

H, W = 480, 848
SIGMA = 10.0 / 255.0
ITERS = 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', default='denoise_plus',
                    choices=['denoise_plus', 'denoise_small'])
    ap.add_argument('--one_len', type=int, default=12)
    ap.add_argument('--bf16', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_denoise: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    state = init_state(build_model(args.variant), seed=1)
    t = args.one_len + 2 * HALO
    clip = np.random.default_rng(0).uniform(0, 1, (t, H, W, 3)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as logs:
        ev = Evaluator(args.variant, state, device='cuda',
                       bf16=args.bf16 or None, result_path=logs)
        plan = ev.window_plan(clip.shape)
        ev.forward_window(clip, SIGMA)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            ev.forward_window(clip, SIGMA)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print(json.dumps({
        'metric': f'{args.variant}_480p_fps', 'value': args.one_len * ITERS / dt,
        'unit': 'frames/s', 'precision': str(ev.dtype).split('.')[-1],
        'window': [t, H, W], 'plan': plan,
        'peak_bytes': torch.cuda.max_memory_allocated(),
        'device': torch.cuda.get_device_name(0), 'card': card}))


if __name__ == '__main__':
    main()
