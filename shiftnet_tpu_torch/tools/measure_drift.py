"""Eval-precision drift of the port: bf16 on the CUDA kernels against
float32 on the all-plain model.

  python -m shiftnet_tpu_torch.tools.measure_drift [--split] [variant ...]

The port's counterpart of the root ``tools/measure_drift.py:35-121``.  The
reference evaluates deblur and denoise_small in fp16
(``inference/test_deblur.py:86``, ``test_denoise_small.py:85``) and
denoise_plus in float32; the port, like the JAX package, maps fp16 to bf16.
This tool gives the PSNR between the bf16 forward on the kernels
(``fused_chw``, the Evaluator's default configuration) and the float32
forward of the all-plain model, the same network on a structured synthetic
clip (deblur: 4 outputs at 720x1280; denoise: 8 at 480x848 with sigma 10
noise; 2+2 halo frames).  The weights are ``init_state(seed=0)`` with every
residual-block ``beta`` set to 0.1 (a zero beta would make every shift block
an identity).  ``--split`` adds the bf16 all-plain leg, which splits the
kernels' drift from the dtype's.  Prints dB and each leg's peak device
memory (``max_memory_allocated``).  Default variants: deblur_plus and
denoise_small.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from shiftnet_tpu_torch.eval.runner import (CONFIG_OVERRIDES, HALO,
                                            Evaluator)
from shiftnet_tpu_torch.models import CONFIGS, build_model, init_state
from shiftnet_tpu_torch.tools.timing import card, require_cuda

SIGMA = 10.0 / 255.0
# (output frames, H, W) by task, as the JAX tool: 720p deblur; denoise at a
# width that is a multiple of 16
SIZES = {'deblur': (4, 720, 1280), 'denoise': (8, 480, 848)}
LEGS = {'bf16-fused': (True, 'fused_chw'), 'f32-plain': (False, 'plain'),
        'bf16-plain': (True, 'plain')}


def synth_clip(t, h, w, seed=0):
    """Structured moving content in [0, 1]: drifting smooth gradients,
    texture and mild noise (white noise alone would hide low-frequency
    precision drift behind its own energy).  ``tools/measure_drift.py:35``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(yy / 37.0 + c) * np.cos(xx / 53.0 - c)
                     for c in range(3)], -1)
    tex = rng.standard_normal((h, w, 3)).astype(np.float32)
    frames = []
    for i in range(t):
        shift = 3 * i
        f = 0.5 + 0.25 * np.roll(base, shift, axis=1) \
            + 0.15 * np.roll(tex, shift // 2, axis=0) \
            + 0.02 * rng.standard_normal((h, w, 3)).astype(np.float32)
        frames.append(np.clip(f, 0, 1))
    return np.stack(frames)


def perturb_betas(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every ``.beta`` (``models/layers.py`` CAB1 / CAB2) set to 0.1
    (``tools/measure_drift.py:54``)."""
    return {k: torch.full_like(v, 0.1) if k.endswith('.beta') else v
            for k, v in state.items()}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """``tools/measure_drift.py:63``, on [0, 255] arrays."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * np.log10(255.0 ** 2 / mse)


def _leg(variant, tag, state, x, sigma, device, overrides, logs) -> dict:
    """One leg's forward of the whole clip: {'peak': its peak device
    memory (None on the CPU), 'out': its output clipped to [0, 255]}."""
    bf16, config = LEGS[tag]
    ev = Evaluator(variant, state, device=device, bf16=bf16,
                   overrides={**CONFIG_OVERRIDES[config], **(overrides or {})},
                   result_path=logs)
    cuda = ev.device.type == 'cuda'
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    o = ev._run(x, sigma)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if not np.isfinite(o).all():
        raise FloatingPointError(f'{variant} {tag}: non-finite output')
    mem = 'not measured' if peak is None else f'{peak / 1e9:.3f} GB'
    print(f'{variant} {tag}: out shape {o.shape} mean {float(o.mean()):.5f} '
          f'peak {mem}', flush=True)
    return {'peak': peak, 'out': np.clip(o, 0, 1) * 255.0}


def run(variant: str, t: int, h: int, w: int, *, split: bool = False,
        device: str = 'cuda', overrides: dict | None = None) -> dict:
    """The legs on one (t + 2*HALO, h, w) clip; returns {'db', 'legs':
    {leg: {'peak', 'out'}}, and with ``split`` 'path_db' (bf16 kernels
    against bf16 plain) and 'dtype_db' (bf16 plain against float32
    plain)}.  TF32 is off while it runs (restored after), so that the
    float32 leg's cuDNN convs and matmuls are float32."""
    noise = CONFIGS[variant].noise_map
    x = synth_clip(t + 2 * HALO, h, w)
    sigma = None
    if noise:
        sigma = SIGMA
        x = np.clip(x + np.random.default_rng(1).normal(0, SIGMA, x.shape),
                    0, 1)
    state = perturb_betas(init_state(
        build_model(variant, **(overrides or {})), seed=0))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as logs:
            legs = {tag: _leg(variant, tag, state, x, sigma, device,
                              overrides, logs)
                    for tag in [*LEGS][:3 if split else 2]}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    res = {'legs': legs, 'db': psnr(legs['bf16-fused']['out'],
                                    legs['f32-plain']['out'])}
    d = res['db']
    print(f'== {variant}: PSNR(bf16 kernels vs f32 plain) = {d:.2f} dB '
          f'(drift {255.0 / (10 ** (d / 20)):.4f}/255 RMS)', flush=True)
    if split:
        res['path_db'] = psnr(legs['bf16-fused']['out'],
                              legs['bf16-plain']['out'])
        res['dtype_db'] = psnr(legs['bf16-plain']['out'],
                               legs['f32-plain']['out'])
        print(f'== {variant}: path drift (bf16 kernels vs plain) = '
              f'{res["path_db"]:.2f} dB; dtype drift (bf16 vs f32, plain) '
              f'= {res["dtype_db"]:.2f} dB', flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('variants', nargs='*', metavar='variant',
                    help=f'of {sorted(CONFIGS)}; default deblur_plus '
                         'denoise_small')
    ap.add_argument('--split', action='store_true',
                    help='add the bf16 all-plain leg')
    args = ap.parse_args(argv)
    variants = args.variants or ['deblur_plus', 'denoise_small']
    for v in variants:
        if v not in CONFIGS:
            ap.error(f'unknown variant {v}')
    require_cuda('measure_drift')
    print(card(), flush=True)
    for v in variants:
        run(v, *SIZES['denoise' if CONFIGS[v].noise_map else 'deblur'],
            split=args.split)
    return 0


if __name__ == '__main__':
    sys.exit(main())
