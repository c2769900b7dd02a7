"""Windowed deblur evaluation on the port (counterpart of
``shiftnet_tpu/eval/runner.py``).

Mirrors ``inference/test_deblur.py``: scan video folders, run windowed
inference, score PSNR and the reference SSIM per frame, log per-video and
total averages to a text log.  The window plan (the whole window at once,
or two half-height tiles) is decided before the run from the device's free
memory and a stated per-pixel estimate, and logged; an out-of-memory error
is not caught.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Any

import numpy as np
import torch

from shiftnet_tpu_torch.eval.metrics import score_pair
from shiftnet_tpu_torch.eval.window import (half_slices, mod_crop,
                                            plan_deblur_chunks)
from shiftnet_tpu_torch.models import CONFIGS, GShiftNetConfig, build_model

HALO = 2  # input frames on each side of a window's outputs (test_deblur.py)
# The inference-local protocol the published numbers use (skimage PSNR and
# the scipy-gaussian SSIM, ``test_deblur.py:25-49``).
METRICS = {'psnr': {'type': 'psnr'}, 'ssim': {'type': 'ssim'}}
# Peak device memory of a deblur_plus forward per input pixel (T * H * W),
# by configuration and compute type, with ~10 % headroom over the peak of a
# 40x720x1280 bf16 window measured on an H100 80GB HBM3 (700 W) by
# chip_smoke.py (PERF.md, "H100 port"): fused_chw 16.98 GB, 461 B/px;
# fused_tfr 39.9 GB, 1082 B/px.  The plain configuration runs the same plain
# Encoder2 as fused_tfr, where that peak is, and shares its figure; the
# float32 figures double the bf16 ones.
WINDOW_BYTES_PER_PX = {
    ('fused_chw', torch.bfloat16): 510, ('fused_chw', torch.float32): 1020,
    ('fused_tfr', torch.bfloat16): 1200, ('fused_tfr', torch.float32): 2400,
    ('plain', torch.bfloat16): 1200, ('plain', torch.float32): 2400,
}


def configuration(cfg: GShiftNetConfig) -> str:
    """Which kernels a model runs: ``fused_chw`` (all of them),
    ``fused_tfr`` (the TFR U-Nets') or ``plain`` (none)."""
    if cfg.fused_chw:
        return 'fused_chw'
    return 'fused_tfr' if cfg.fused_tfr else 'plain'


# The model overrides that select each configuration.
CONFIG_OVERRIDES = {'fused_chw': {'fused_chw': True},
                    'fused_tfr': {'fused_chw': False, 'fused_tfr': True},
                    'plain': {'fused_chw': False, 'fused_tfr': False}}


def _imread(path: str) -> np.ndarray:
    """An RGB uint8 frame (the port's copy of
    ``shiftnet_tpu/data/video_dataset.py:_imread``)."""
    import imageio.v2 as imageio
    img = imageio.imread(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


class EvalLogger:
    """Reference ``Traverse_Logger`` (``test_deblur.py:15-23``)."""

    def __init__(self, result_dir: str, filename: str):
        os.makedirs(result_dir, exist_ok=True)
        self.path = os.path.join(result_dir, filename)

    def write(self, msg: str):
        print(msg, flush=True)
        with open(self.path, 'a') as f:
            f.write(msg + '\n')


class Evaluator:
    """deblur evaluation on ``device`` with a torch-keyed ``state``
    (``tools.params_io.load_state`` or ``models.init_state``).

    Deblur computes in bf16 with float32 parameters by default, and the
    model runs on the CUDA kernels (``fused_chw``; the plain versions on the
    CPU), as the JAX Evaluator does (``shiftnet_tpu/eval/runner.py:74``)."""

    def __init__(self, variant: str, state: dict[str, torch.Tensor], *,
                 device: str | torch.device, result_path: str = 'results',
                 bf16: bool | None = None, save_images: bool = False,
                 overrides: dict | None = None):
        if bf16 is None:
            bf16 = not CONFIGS[variant].noise_map
        overrides = dict(overrides or {})
        overrides.setdefault('fused_chw', True)
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = build_model(variant, past_frames=HALO,
                                 future_frames=HALO, **overrides)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self.bytes_per_px = WINDOW_BYTES_PER_PX[
            (configuration(self.model.cfg), self.dtype)]
        self.save_images = save_images
        self.result_path = result_path
        stamp = time.strftime('%Y-%m-%d %H:%M:%S')
        self.logger = EvalLogger(result_path, f'inference_log_{stamp}.txt')

    def _budget(self) -> int | None:
        """Device bytes a window may use; None on the CPU."""
        if self.device.type == 'cuda':
            # free memory plus what the caching allocator holds unused
            free = torch.cuda.mem_get_info(self.device)[0]
            return (free + torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device))
        return None  # host memory: no device budget to plan against

    def window_plan(self, shape: tuple) -> str:
        """'full' when the window's estimated peak fits the budget, else
        'half' (two half-height tiles, ``eval.window.half_slices``)."""
        t, h, w = shape[:3]
        need = t * h * w * self.bytes_per_px
        budget = self._budget()
        return 'full' if budget is None or need <= budget else 'half'

    def _run(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        xt = xt.to(self.device).permute(0, 3, 1, 2).to(self.dtype).contiguous()
        with torch.inference_mode():
            out = self.model(xt)
        return out.permute(0, 2, 3, 1).float().cpu().numpy()

    def forward_window(self, x: np.ndarray) -> np.ndarray:
        """One (T, H, W, 3) window in [0, 1] -> (T - 2*HALO, H, W, 3)
        float32."""
        tt, hh, ww, _ = x.shape
        plan = self.window_plan(x.shape)
        budget = self._budget()
        self.logger.write(
            f'[plan] window {tuple(x.shape)} {self.dtype}: estimated '
            f'{tt * hh * ww * self.bytes_per_px / 1e9:.2f} GB, '
            f'budget {"host" if budget is None else f"{budget / 1e9:.2f} GB"}'
            f' -> {plan}')
        if plan == 'full':
            return self._run(x)
        out = np.zeros((tt - 2 * HALO, hh, ww, 3), np.float32)
        for in_sl, crop_sl, out_sl in half_slices(hh, ww):
            o = self._run(x[:, in_sl[0], in_sl[1]])
            out[:, out_sl[0], out_sl[1]] = o[:, crop_sl[0], crop_sl[1]]
        return out

    def eval_deblur(self, data_path: str, one_len: int = 48) -> dict:
        """Protocol of ``test_deblur.py:91-177``; returns summary metrics."""
        input_root = os.path.join(data_path, 'blur')
        gt_root = os.path.join(data_path, 'gt')
        totals: dict[str, dict[str, list]] = {}
        for v in sorted(os.listdir(input_root)):
            in_frames = sorted(glob.glob(os.path.join(input_root, v, '*')))
            gt_frames = sorted(glob.glob(os.path.join(gt_root, v, '*')))
            vsc = {name: [] for name in METRICS}
            for ch in plan_deblur_chunks(len(in_frames), one_len, HALO):
                t0 = time.time()
                inp = np.stack([_imread(p) for p in
                                in_frames[ch.in_start:ch.in_stop]])
                gts = [mod_crop(_imread(p), 4) for p in
                       gt_frames[ch.out_start:ch.out_stop]]
                x = mod_crop(inp, 4).astype(np.float32) / 255.0
                t1 = time.time()
                out = self.forward_window(x)
                t2 = time.time()
                sc = self._score(out, gts, v, ch.out_start)
                for name in vsc:
                    vsc[name] += sc[name]
                t3 = time.time()
                self.logger.write(
                    f'> {v}-{ch.in_start:05d} ' + self._fmt_last(sc)
                    + f' pre:{t1 - t0:.3f}s fwd:{t2 - t1:.3f}s '
                    f'post:{t3 - t2:.3f}s')
            totals[v] = vsc
        return self._summarize(totals)

    def _score(self, out: np.ndarray, gts, video: str,
               index0: int) -> dict[str, list]:
        """Every configured metric per frame (``eval.metrics.score_pair``)."""
        scores: dict[str, list] = {name: [] for name in METRICS}
        for i, gt in enumerate(gts):
            img = np.clip(out[i], 0.0, 1.0) * 255.0
            for name, val in score_pair(img, gt, METRICS).items():
                scores[name].append(val)
            if self.save_images:
                import imageio.v2 as imageio
                d = os.path.join(self.result_path, video)
                os.makedirs(d, exist_ok=True)
                imageio.imwrite(os.path.join(d, f'{index0 + i:03d}.png'),
                                img.astype(np.uint8))
        return scores

    @staticmethod
    def _fmt_last(sc: dict[str, list]) -> str:
        return ', '.join(f'{name.upper()}={vals[-1]:.5g}'
                         for name, vals in sc.items() if vals)

    def _summarize(self, totals: dict[str, dict[str, list]]) -> dict:
        names = list(METRICS)
        sums = {n: 0.0 for n in names}
        n_frames = 0
        for v, vsc in totals.items():
            self.logger.write(f'# Video:{v} ' + ', '.join(
                f'AVG-{n.upper()}={float(np.mean(vsc[n])):.5g}'
                for n in names))
            for n in names:
                sums[n] += sum(vsc[n])
            n_frames += len(vsc[names[0]])
        res: dict[str, Any] = {n: sums[n] / n_frames for n in names}
        res['n_frames'] = n_frames
        self.logger.write('# Total ' + ', '.join(
            f'AVG-{n.upper()}={res[n]:.5g}' for n in names))
        return res
