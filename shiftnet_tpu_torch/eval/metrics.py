"""The metrics of the published deblur numbers (``inference/test_deblur.py``),
on numpy, and their batched counterparts on torch tensors.

The port's own copy of ``shiftnet_tpu/eval/metrics.py:26-115`` (``psnr``,
``ssim``; ``psnr_t`` and ``ssim_t`` for ``psnr_jax`` and ``ssim_jax``):
the port imports nothing of the JAX package.  Scoring goes through
``eval/registry.py``.

- PSNR: ``skimage.metrics.peak_signal_noise_ratio(output*255, gt,
  data_range=255)`` on float arrays (``test_deblur.py:142``).
- SSIM: a scipy ``gaussian_filter`` variant, sigma 1.5 over the CHW array
  (the channel axis is filtered too), no border crop
  (``test_deblur.py:25-49``).
"""
from __future__ import annotations

import numpy as np
import torch
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


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    # scipy.ndimage._filters._gaussian_kernel1d
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


def psnr_t(img: torch.Tensor, gt: torch.Tensor,
           data_range: float = 255.0) -> torch.Tensor:
    """Batched PSNR of (..., H, W, C) tensors in the same range, in float32
    on their device (``shiftnet_tpu/eval/metrics.py:69`` ``psnr_jax``)."""
    x = img.float()
    y = gt.float()
    mse = torch.mean((x - y) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10((data_range ** 2) / mse)


def ssim_t(img: torch.Tensor, gt: torch.Tensor, sd: float = 1.5,
           c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """The reference SSIM of (T, H, W, C) tensors in [0, 255], one value a
    frame, in float32 on their device (``shiftnet_tpu/eval/metrics.py:79``
    ``ssim_jax``): scipy's reflect-mode gaussian (truncate 4.0) along H, W
    and the channel axis."""
    radius = int(4.0 * sd + 0.5)
    k = torch.from_numpy(_gaussian_kernel1d(sd, radius)).to(img.device)

    def filt_axis(v, axis):
        # scipy's 'reflect' repeats the edge sample (numpy's 'symmetric'),
        # also where the radius exceeds the axis (C = 3)
        n = v.shape[axis]
        p = torch.arange(-radius, n + radius, device=v.device) % (2 * n)
        idx = torch.where(p < n, p, 2 * n - 1 - p)
        vp = v.index_select(axis, idx).movedim(axis, -1)
        out = sum(k[j] * vp[..., j:j + n] for j in range(2 * radius + 1))
        return out.movedim(-1, axis)

    def gauss3(v):
        for ax in (1, 2, 3):
            v = filt_axis(v, ax)
        return v

    x = img.float() / 255.0
    y = gt.float() / 255.0
    mu1, mu2 = gauss3(x), gauss3(y)
    s1 = gauss3(x * x) - mu1 * mu1
    s2 = gauss3(y * y) - mu2 * mu2
    s12 = gauss3(x * y) - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return torch.mean(num / den, dim=(1, 2, 3))
