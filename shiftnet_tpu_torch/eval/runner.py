"""Windowed deblur and denoise evaluation on the port (counterpart of
``shiftnet_tpu/eval/runner.py``).

Mirrors ``inference/test_deblur.py`` and ``inference/test_denoise.py``: scan
video folders, run windowed inference (denoise: on clips with seeded
gaussian noise and a constant noise map), score every configured metric of
``eval/registry.py`` per frame (by default PSNR and the reference SSIM),
log per-video and total averages to a text log.  ``grids`` switches the
forward to the reference's validation tiling with rot/flip test-time
augmentation (``forward_grids``).  The window plan
is decided before the run and logged: the whole window at once, two
half-height tiles when the device's free memory is below a stated per-pixel
estimate, or the reference's four quadrant tiles when asked for or when the
frame's height or width is not a multiple of 8 (the model's three stride-2
levels need one).  An out-of-memory error is not caught.

``tp`` (sequence-parallel inference, ``shiftnet_tpu/eval/runner.py:
107-120, :246-290``) splits each window's frames over the ranks of a
process group (``parallel/temporal.py``): every rank holds the window,
runs its frames with 2-frame halos from its neighbours, and the restored
frames are gathered on every rank.  A window whose T does not divide by tp
is split into shards of ``ceil(T/tp)`` and ``floor(T/tp)`` frames; no frame
is repeated to pad it (as JAX does, ``runner.py:254-259``).  The grids
forward and the quadrant plan raise under tp (JAX runs them unsharded,
``runner.py:148-157, :358-366``).  Only rank 0 scores, logs and writes
images.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Any

import numpy as np
import torch

from shiftnet_tpu_torch.data.video_dataset import _imread
from shiftnet_tpu_torch.eval.grids import (extract_grids, merge_grids,
                                           plan_grids)
from shiftnet_tpu_torch.eval.registry import METRIC_FUNCS, score_pair
from shiftnet_tpu_torch.eval.window import (half_slices, mod_crop,
                                            plan_deblur_chunks,
                                            plan_denoise_chunks,
                                            quadrant_pads, quadrant_slices)
from shiftnet_tpu_torch.models import CONFIGS, GShiftNetConfig, build_model
from shiftnet_tpu_torch.parallel import mesh as pmesh
from shiftnet_tpu_torch.parallel.temporal import (gather_frames,
                                                  shard_bounds,
                                                  temporal_parallel_forward)

HALO = 2  # input frames on each side of a window's outputs (test_deblur.py)
# The default of ``Evaluator(metrics=...)``: the inference-local protocol
# the published numbers use (skimage PSNR and the scipy-gaussian SSIM,
# ``test_deblur.py:25-49``), as in ``shiftnet_tpu/eval/runner.py:87-91``.
METRICS = {'psnr': {'type': 'psnr'}, 'ssim': {'type': 'ssim'}}
# Peak device memory of a forward per input pixel (T * H * W) in a bf16
# window, by variant and configuration, with ~10 % headroom over peaks
# measured on an H100 80GB HBM3 (700 W) by chip_smoke.py (PERF.md,
# Findings); a float32 window takes twice the figure.  The peak of every
# fused_chw window sits in Encoder2's shift blocks at H/2 (decoder_level1,
# and in the small variants equally encoder_level1), so conv_concat (which
# drops the rconcat and conv_hr0 concats) shares its configuration's
# figure.
# - deblur_plus, 40x720x1280 bf16: fused_chw and conv_concat 16.984 GB,
#   461 B/px; fused_tfr 38.4-39.9 GB, up to 1082 B/px.  The plain
#   configuration runs the same plain Encoder2 as fused_tfr, where that
#   peak is, and shares its figure.
# - denoise_plus, float32, 480x848: fused_chw and conv_concat 5.456 GB at
#   T = 16 (838 B/px) and 18.207 GB at T = 54 (828 B/px); the bf16 figure
#   is half of that, not measured.  fused_tfr and plain were not measured
#   and take deblur_plus's figures.
# - deblur_small, 40x720x1280 bf16: fused_chw and conv_concat 12.084 GB,
#   328 B/px; denoise_small, float32, 16x480x848: fused_chw and conv_concat
#   3.962 GB, 608 B/px (bf16 figure 304, not measured).  fused_tfr and
#   plain were not measured and take deblur_plus's figures.
_BF16_BYTES_PER_PX = {
    ('deblur_plus', 'fused_chw'): 510, ('deblur_plus', 'conv_concat'): 510,
    ('deblur_plus', 'fused_tfr'): 1200, ('deblur_plus', 'plain'): 1200,
    ('denoise_plus', 'fused_chw'): 461, ('denoise_plus', 'conv_concat'): 461,
    ('denoise_plus', 'fused_tfr'): 1200, ('denoise_plus', 'plain'): 1200,
    ('deblur_small', 'fused_chw'): 361, ('deblur_small', 'conv_concat'): 361,
    ('deblur_small', 'fused_tfr'): 1200, ('deblur_small', 'plain'): 1200,
    ('denoise_small', 'fused_chw'): 335,
    ('denoise_small', 'conv_concat'): 335,
    ('denoise_small', 'fused_tfr'): 1200, ('denoise_small', 'plain'): 1200,
}
WINDOW_BYTES_PER_PX = {
    (variant, config, dtype): factor * b
    for (variant, config), b in _BF16_BYTES_PER_PX.items()
    for dtype, factor in ((torch.bfloat16, 1), (torch.float32, 2))}


def configuration(cfg: GShiftNetConfig) -> str:
    """Which kernels a model runs: ``fused_chw`` (all of them but
    conv_cat), ``conv_concat`` (all of them, conv_cat at rconcat and
    conv_hr0), ``fused_tfr`` (the TFR U-Nets') or ``plain`` (none)."""
    if cfg.fused_chw:
        return 'conv_concat' if cfg.conv_concat else 'fused_chw'
    return 'fused_tfr' if cfg.fused_tfr else 'plain'


# The model overrides that select each configuration.
CONFIG_OVERRIDES = {
    'fused_chw': {'fused_chw': True, 'conv_concat': False},
    'conv_concat': {'fused_chw': True, 'conv_concat': True},
    'fused_tfr': {'fused_chw': False, 'fused_tfr': True,
                  'conv_concat': False},
    'plain': {'fused_chw': False, 'fused_tfr': False, 'conv_concat': False}}


class EvalLogger:
    """Reference ``Traverse_Logger`` (``test_deblur.py:15-23``); writes
    nothing where ``enabled`` is false (the ranks other than 0)."""

    def __init__(self, result_dir: str, filename: str, enabled: bool = True):
        self.enabled = enabled
        if enabled:
            os.makedirs(result_dir, exist_ok=True)
        self.path = os.path.join(result_dir, filename)

    def write(self, msg: str):
        if not self.enabled:
            return
        print(msg, flush=True)
        with open(self.path, 'a') as f:
            f.write(msg + '\n')


class Evaluator:
    """deblur / denoise evaluation on ``device`` with a torch-keyed
    ``state`` (``tools.params_io.load_state`` or ``models.init_state``).

    Deblur computes in bf16 and denoise in float32 by default, with float32
    parameters, and the model runs on the CUDA kernels (``fused_chw``; the
    plain versions on the CPU), as the JAX Evaluator does
    (``shiftnet_tpu/eval/runner.py:51-74``).  ``metrics``: {name: {'type':
    <a name of ``eval.registry.METRIC_FUNCS``>, **kwargs}}, the reference's
    ``val.metrics``; ``METRICS`` by default.  ``tp``: split each window's
    frames over the ranks of the initialized process group, which must
    have ``tp`` ranks."""

    def __init__(self, variant: str, state: dict[str, torch.Tensor], *,
                 device: str | torch.device, result_path: str = 'results',
                 bf16: bool | None = None, save_images: bool = False,
                 overrides: dict | None = None, metrics: dict | None = None,
                 tp: int = 1):
        self.tp = int(tp)
        if self.tp > 1:
            n = pmesh.world_size()
            if n != self.tp:
                raise ValueError(
                    f'tp={self.tp} needs an initialized process group of '
                    f'{self.tp} ranks (torchrun --nproc_per_node '
                    f'{self.tp}); this process has {n}')
        self.primary = pmesh.is_primary()
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
        self.noise_map = self.model.cfg.noise_map
        self.bytes_per_px = WINDOW_BYTES_PER_PX[
            (variant, configuration(self.model.cfg), self.dtype)]
        self.metrics = dict(metrics) if metrics else dict(METRICS)
        unknown = sorted({str(m.get('type')) for m in self.metrics.values()}
                         - set(METRIC_FUNCS))
        if unknown:
            raise ValueError(f'unknown metric types {unknown}; the registry '
                             f'has {sorted(METRIC_FUNCS)}')
        self.save_images = save_images
        self.result_path = result_path
        stamp = time.strftime('%Y-%m-%d %H:%M:%S')
        self.logger = EvalLogger(result_path, f'inference_log_{stamp}.txt',
                                 enabled=self.primary)

    def _budget(self) -> int | None:
        """Device bytes a window may use; None on the CPU."""
        if self.device.type == 'cuda':
            # free memory plus what the caching allocator holds unused
            free = torch.cuda.mem_get_info(self.device)[0]
            return (free + torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device))
        return None  # host memory: no device budget to plan against

    def window_plan(self, shape: tuple, quadrant: bool = False) -> str:
        """'quadrant' (``eval.window.quadrant_slices``) when asked for or
        when H or W is not a multiple of 8; else 'full' when the window's
        estimated peak fits the budget, else 'half' (two half-height tiles,
        ``eval.window.half_slices``).  Under tp the estimate is of the
        rank's frames (its largest shard plus both halos), and the ranks
        take the plan of the rank with the least room: ranks that share a
        card each see the other's memory in its budget."""
        t, h, w = shape[:3]
        if self.tp > 1:
            t = -(-t // self.tp) + 2 * HALO
        if quadrant or h % 8 or w % 8:
            ph, pw = quadrant_pads(h, w)
            if h % 2 or w % 2 or h // 2 < ph or w // 2 < pw:
                raise ValueError(
                    f'window {h}x{w}: the quadrant tiles need an even height '
                    'and width of at least 48 (tiles h/2 + pad, multiples '
                    'of 16)')
            return 'quadrant'
        need = t * h * w * self.bytes_per_px
        budget = self._budget()
        half = budget is not None and need > budget
        if self.tp > 1:  # one plan for all ranks
            flag = torch.tensor([int(half)], device=self.device)
            torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MAX)
            half = bool(flag.item())
        return 'half' if half else 'full'

    def _run(self, x: np.ndarray, sigma: float | None) -> np.ndarray:
        """The model on one (T, H, W, 3) input; under tp this rank's shard
        of its frames, through the halo exchange, gathered on every
        rank."""
        t_all = x.shape[0]
        if self.tp > 1:
            bounds = shard_bounds(t_all, self.tp)
            s, e = bounds[pmesh.rank()]
            x = x[s:e]
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        xt = xt.to(self.device).permute(0, 3, 1, 2).to(self.dtype).contiguous()
        with torch.inference_mode():
            nm = None
            if sigma is not None:  # the constant noise map, on the device
                t, _, h, w = xt.shape
                nm = torch.full((t, 1, h, w), sigma, device=self.device,
                                dtype=self.dtype)
            if self.tp > 1:
                world = torch.distributed.group.WORLD
                fwd = temporal_parallel_forward(self.model, world, HALO)
                out = gather_frames(fwd(xt, nm), world, bounds)
                out = out[HALO:t_all - HALO]
            else:
                out = self.model(xt, nm)
        return out.permute(0, 2, 3, 1).float().cpu().numpy()

    def forward_window(self, x: np.ndarray, sigma: float | None = None, *,
                       quadrant: bool = False) -> np.ndarray:
        """One (T, H, W, 3) window in [0, 1] -> (T - 2*HALO, H, W, 3)
        float32.  ``sigma``: the noise level in [0, 1] of the denoise
        variants' constant noise map, required exactly when the variant
        takes one.  ``quadrant`` forces the reference's four tiles."""
        if (sigma is not None) != self.noise_map:
            raise ValueError('sigma is required exactly when the variant '
                             'takes a noise map')
        tt, hh, ww, _ = x.shape
        plan = self.window_plan(x.shape, quadrant)
        if plan == 'quadrant' and self.tp > 1:
            raise ValueError(
                f'window {hh}x{ww}: the quadrant plan does not run under '
                f'tp={self.tp}')
        budget = self._budget()
        t_rank = tt
        if self.tp > 1:
            sizes = [e - s for s, e in shard_bounds(tt, self.tp)]
            t_rank = max(sizes) + 2 * HALO
            self.logger.write(
                f'[tp] window T={tt} over {self.tp} ranks: shards of '
                f'{sizes} frames (+{HALO}+{HALO} halo), no frame repeated')
        self.logger.write(
            f'[plan] window {tuple(x.shape)} {self.dtype}: estimated '
            f'{t_rank * hh * ww * self.bytes_per_px / 1e9:.2f} GB'
            f'{" a rank" if self.tp > 1 else ""}, '
            f'budget {"host" if budget is None else f"{budget / 1e9:.2f} GB"}'
            f' -> {plan}')
        if plan == 'full':
            return self._run(x, sigma)
        tiles = (half_slices if plan == 'half' else quadrant_slices)(hh, ww)
        out = np.zeros((tt - 2 * HALO, hh, ww, 3), np.float32)
        for in_sl, crop_sl, out_sl in tiles:
            o = self._run(x[:, in_sl[0], in_sl[1]], sigma)
            out[:, out_sl[0], out_sl[1]] = o[:, crop_sl[0], crop_sl[1]]
        return out

    def forward_grids(self, x: np.ndarray, sigma: float | None = None, *,
                      crop_size: int = 256, trans_num: int = 1) -> np.ndarray:
        """One (T, H, W, 3) window in [0, 1] -> (T - 2*HALO, H, W, 3) float32
        through the reference's validation protocol
        (``image_restoration_model.py:161-252``: ``grids``, a forward per
        crop, ``grids_inverse``), as ``shiftnet_tpu/eval/runner.py:135-160``:
        ``min(crop_size, H, W)`` square crops covering the frame, each in
        ``trans_num`` rot/flip transforms, each run whole through the model
        (no window plan), averaged where crops overlap."""
        if (sigma is not None) != self.noise_map:
            raise ValueError('sigma is required exactly when the variant '
                             'takes a noise map')
        if self.tp > 1:
            raise ValueError(f'forward_grids does not run under tp={self.tp}'
                             ' (the JAX Evaluator runs it unsharded)')
        t, h, w, _ = x.shape
        cs = min(crop_size, h, w)
        if cs % 8:
            raise ValueError(
                f'grids crop {cs} (crop_size {crop_size}, frame {h}x{w}): '
                "the model's three stride-2 levels need a multiple of 8")
        plans = plan_grids(h, w, cs, trans_num)
        self.logger.write(f'[grids] window {tuple(x.shape)} {self.dtype}: '
                          f'{len(plans) // trans_num} crops of {cs}x{cs} x '
                          f'{trans_num} transforms')
        preds = [self._run(part, sigma)
                 for part in extract_grids(x, plans, cs)]
        return merge_grids(preds, plans, (t - 2 * HALO, h, w, 3), cs)

    def eval_deblur(self, data_path: str, one_len: int = 48, *,
                    grids: bool = False, crop_size: int = 256,
                    trans_num: int = 1) -> dict:
        """Protocol of ``test_deblur.py:91-177``; returns summary metrics.
        ``grids`` runs each chunk through ``forward_grids``."""
        input_root = os.path.join(data_path, 'blur')
        gt_root = os.path.join(data_path, 'gt')
        totals: dict[str, dict[str, list]] = {}
        for v in sorted(os.listdir(input_root)):
            in_frames = sorted(glob.glob(os.path.join(input_root, v, '*')))
            gt_frames = sorted(glob.glob(os.path.join(gt_root, v, '*')))
            vsc = {name: [] for name in self.metrics}
            for ch in plan_deblur_chunks(len(in_frames), one_len, HALO):
                t0 = time.time()
                inp = np.stack([_imread(p) for p in
                                in_frames[ch.in_start:ch.in_stop]])
                gts = [mod_crop(_imread(p), 4) for p in
                       gt_frames[ch.out_start:ch.out_stop]]
                x = mod_crop(inp, 4).astype(np.float32) / 255.0
                t1 = time.time()
                if grids:
                    out = self.forward_grids(x, crop_size=crop_size,
                                             trans_num=trans_num)
                else:
                    out = self.forward_window(x)
                t2 = time.time()
                if not self.primary:
                    continue
                sc = self._score(out, gts, v, ch.out_start)
                for name in vsc:
                    vsc[name] += sc[name]
                t3 = time.time()
                self.logger.write(
                    f'> {v}-{ch.in_start:05d} ' + self._fmt_last(sc)
                    + f' pre:{t1 - t0:.3f}s fwd:{t2 - t1:.3f}s '
                    f'post:{t3 - t2:.3f}s')
            totals[v] = vsc
        return self._summarize(totals) if self.primary else {}

    def eval_denoise(self, data_path: str, sigma: float, *,
                     tile: bool = False, seed: int = 0, grids: bool = False,
                     crop_size: int = 256, trans_num: int = 1) -> dict:
        """Protocol of ``test_denoise.py:91-224``: GT-only video folders,
        gaussian noise of ``sigma`` (on the 0-255 scale) drawn from
        ``np.random.default_rng(seed)`` as the JAX Evaluator draws it, so a
        seed gives both packages the same noisy clips; PSNR/SSIM against
        the GT.  ``tile`` forces the reference's quadrant tiling;
        ``grids`` runs each clip through ``forward_grids`` instead, on the
        same noise."""
        rng = np.random.default_rng(seed)
        s = sigma / 255.0
        totals: dict[str, dict[str, list]] = {}
        for v in sorted(os.listdir(data_path)):
            frames = sorted(glob.glob(os.path.join(data_path, v, '*')))
            vsc = {name: [] for name in self.metrics}
            for ch in plan_denoise_chunks(len(frames), HALO):
                t0 = time.time()
                gt_clip = mod_crop(np.stack(
                    [_imread(p) for p in frames[ch.in_start:ch.in_stop]]), 4)
                clean = gt_clip.astype(np.float32) / 255.0
                noisy = clean + rng.normal(0, s, clean.shape).astype(
                    np.float32)
                t1 = time.time()
                if grids:
                    out = self.forward_grids(noisy, s, crop_size=crop_size,
                                             trans_num=trans_num)
                else:
                    out = self.forward_window(noisy, s, quadrant=tile)
                t2 = time.time()
                if not self.primary:
                    continue
                gts = list(gt_clip[HALO:gt_clip.shape[0] - HALO])
                sc = self._score(out, gts, v, ch.out_start)
                for name in vsc:
                    vsc[name] += sc[name]
                t3 = time.time()
                self.logger.write(
                    f'> {v}-{ch.in_start:05d} ' + self._fmt_last(sc)
                    + f' pre:{t1 - t0:.3f}s fwd:{t2 - t1:.3f}s '
                    f'post:{t3 - t2:.3f}s')
            totals[v] = vsc
        if not self.primary:
            return {}
        return self._summarize(totals, per_video_avg=True)

    def _score(self, out: np.ndarray, gts, video: str,
               index0: int) -> dict[str, list]:
        """Every configured metric per frame (``eval.registry.score_pair``,
        the reference's ``with_metrics`` loop)."""
        scores: dict[str, list] = {name: [] for name in self.metrics}
        for i, gt in enumerate(gts):
            img = np.clip(out[i], 0.0, 1.0) * 255.0
            for name, val in score_pair(img, gt, self.metrics).items():
                scores[name].append(val)
            if self.save_images:
                from PIL import Image
                d = os.path.join(self.result_path, video)
                os.makedirs(d, exist_ok=True)
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(d, f'{index0 + i:03d}.png'))
        return scores

    @staticmethod
    def _fmt_last(sc: dict[str, list]) -> str:
        return ', '.join(f'{name.upper()}={vals[-1]:.5g}'
                         for name, vals in sc.items() if vals)

    def _summarize(self, totals: dict[str, dict[str, list]],
                   per_video_avg: bool = False) -> dict:
        """Averages over all frames; with ``per_video_avg`` also the mean
        of the per-video averages (``<metric>_video_avg``)."""
        names = list(self.metrics)
        sums = {n: 0.0 for n in names}
        vavg = {n: 0.0 for n in names}
        n_frames = 0
        for v, vsc in totals.items():
            avgs = {n: float(np.mean(vsc[n])) for n in names}
            self.logger.write(f'# Video:{v} ' + ', '.join(
                f'AVG-{n.upper()}={avgs[n]:.5g}' for n in names))
            for n in names:
                sums[n] += sum(vsc[n])
                vavg[n] += avgs[n]
            n_frames += len(vsc[names[0]])
        res: dict[str, Any] = {n: sums[n] / n_frames for n in names}
        res['n_frames'] = n_frames
        self.logger.write('# Total ' + ', '.join(
            f'AVG-{n.upper()}={res[n]:.5g}' for n in names))
        if per_video_avg:
            for n in names:
                res[f'{n}_video_avg'] = vavg[n] / len(totals)
            self.logger.write('# Total ' + ', '.join(
                f"AVG-{n.upper()}={res[f'{n}_video_avg']:.5g}"
                for n in names))
        return res
