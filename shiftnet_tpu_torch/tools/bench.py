"""Benchmark of the port: deblur_plus 720p throughput on one H100.

  python -m shiftnet_tpu_torch.tools.bench [--windows N]

The protocol of the JAX package's ``bench.py``, on the port: deblur_plus on
seeded random weights (float32 parameters, bf16 compute, the Evaluator's
default ``fused_chw`` configuration), a seeded 1280x720 clip of ``one_len``
36 output frames plus 2+2 halo (T = 40), through the port's
``Evaluator.forward_window`` on the window plan the Evaluator takes from the
device's free memory; one warm-up window, then ``--windows`` (5) timed
windows on the host clock, fenced by ``torch.cuda.synchronize()``.  Unlike
the JAX bench, the timed windows include the clip's copy to the device and
the output's copy back, as every window of the port's eval CLI does.

Prints the card's name and power limit on standard error, then one JSON
line with the JAX bench's keys (``metric``, ``value`` in frames/s,
``unit``, ``vs_baseline`` against 30 fps) under the metric name
``deblur_plus_720p_fps_h100``, beside the window, plan and card.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from shiftnet_tpu_torch.eval.runner import HALO, Evaluator
from shiftnet_tpu_torch.models import build_model, init_state

H, W = 720, 1280
ONE_LEN = 36
BASELINE_FPS = 30.0  # BASELINE.md: the north star, 720p frames a second
METRIC = 'deblur_plus_720p_fps_h100'


def run(windows: int = 5) -> dict:
    """The benchmark; returns its JSON record."""
    from shiftnet_tpu_torch.tools.timing import card, require_cuda
    require_cuda('bench')
    smi = card()
    print(smi, file=sys.stderr, flush=True)
    state = init_state(build_model('deblur_plus'), seed=1)
    t = ONE_LEN + 2 * HALO
    clip = np.random.default_rng(0).uniform(0, 1, (t, H, W, 3)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as logs:
        ev = Evaluator('deblur_plus', state, device='cuda', result_path=logs)
        plan = ev.window_plan(clip.shape)
        ev.forward_window(clip)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(windows):
            ev.forward_window(clip)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    fps = ONE_LEN * windows / dt
    return {'metric': METRIC, 'value': fps, 'unit': 'frames/s',
            'vs_baseline': fps / BASELINE_FPS, 'windows': windows,
            'window': [t, H, W], 'plan': plan,
            'precision': str(ev.dtype).split('.')[-1],
            'device': torch.cuda.get_device_name(0), 'card': smi}


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(prog='bench')
    ap.add_argument('--windows', type=int, default=5)
    args = ap.parse_args(list(argv))
    print(json.dumps(run(args.windows)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
