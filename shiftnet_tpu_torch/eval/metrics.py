"""The metrics of the published deblur numbers (``inference/test_deblur.py``),
on numpy.

The port's own copy of ``shiftnet_tpu/eval/metrics.py:26-66`` (``psnr``,
``ssim``) and a small ``score_pair`` in the shape of
``shiftnet_tpu/eval/registry.py:score_pair``: the port imports nothing of
the JAX package.

- PSNR: ``skimage.metrics.peak_signal_noise_ratio(output*255, gt,
  data_range=255)`` on float arrays (``test_deblur.py:142``).
- SSIM: a scipy ``gaussian_filter`` variant, sigma 1.5 over the CHW array
  (the channel axis is filtered too), no border crop
  (``test_deblur.py:25-49``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
from scipy.ndimage import gaussian_filter


def psnr(img: np.ndarray, gt: np.ndarray, data_range: float = 255.0) -> float:
    """PSNR matching skimage.peak_signal_noise_ratio on float inputs."""
    img = np.asarray(img, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    mse = np.mean((img - gt) ** 2)
    if mse == 0:
        return float('inf')
    return float(10.0 * np.log10((data_range ** 2) / mse))


def ssim(img: np.ndarray, gt: np.ndarray, sd: float = 1.5,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> float:
    """The reference's ``ssim_calculate`` on HWC uint8-range arrays: /255,
    CHW, 3-D gaussian filter (reflect), the SSIM map, its mean."""
    x = (np.asarray(img, dtype=np.float32) / 255).transpose(2, 0, 1)
    y = (np.asarray(gt, dtype=np.float32) / 255).transpose(2, 0, 1)
    mu1 = gaussian_filter(x, sd)
    mu2 = gaussian_filter(y, sd)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = gaussian_filter(x * x, sd) - mu1_sq
    sigma2_sq = gaussian_filter(y * y, sd) - mu2_sq
    sigma12 = gaussian_filter(x * y, sd) - mu1_mu2
    num = (2 * mu1_mu2 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return float(np.mean(num / den))


METRIC_FUNCS = {'psnr': psnr, 'ssim': ssim}


def score_pair(img: np.ndarray, gt: np.ndarray,
               metrics: dict[str, dict[str, Any]]) -> dict[str, float]:
    """Every configured metric on one (restored, gt) pair of uint8-range
    HWC images; ``metrics``: {name: {'type': 'psnr' | 'ssim', **kwargs}}."""
    out = {}
    for name, opt in metrics.items():
        kw = dict(opt)
        out[name] = float(METRIC_FUNCS[kw.pop('type')](img, gt, **kw))
    return out
