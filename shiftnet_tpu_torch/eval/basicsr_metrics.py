"""BasicSR-style PSNR and SSIM with crop-border and Y-channel options, on
numpy: the config-driven validation metrics.

The port's own copy of ``shiftnet_tpu/eval/basicsr_metrics.py:19-103``,
the surface of the reference's ``basicsr/metrics/psnr_ssim.py``:
``calculate_psnr`` (:15-69) and ``calculate_ssim`` (:235-309).  The colour
path is an 11x11x11 separable-gaussian 3-D SSIM over (H, W, C) with
replicate padding (``_ssim_3d``, :151-190); the Y-channel path the 2-D
11x11 gaussian with a replicate border (``_ssim_cly``, :192-232).  The
published numbers use the simpler scipy-gaussian SSIM of ``eval/metrics.py``.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate

from shiftnet_tpu_torch.eval.color import reorder_image, to_y_channel


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel(11, 1.5)'s outer product
    x = np.arange(size) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def calculate_psnr(img1, img2, crop_border: int = 0, input_order: str = 'HWC',
                   test_y_channel: bool = False) -> float:
    """``shiftnet_tpu/eval/basicsr_metrics.py:27``."""
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    img1 = reorder_image(np.asarray(img1), input_order).astype(np.float64)
    img2 = reorder_image(np.asarray(img2), input_order).astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float('inf')
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return float(20.0 * np.log10(max_value / np.sqrt(mse)))


def _ssim_map(img1, img2, filt, c1, c2):
    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 ** 2) - mu1_sq
    s2 = filt(img2 ** 2) - mu2_sq
    s12 = filt(img1 * img2) - mu1_mu2
    return ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _ssim_y(img1: np.ndarray, img2: np.ndarray) -> float:
    """Y-channel SSIM: 2-D 11x11 gaussian, replicate border, full-map mean
    (``shiftnet_tpu/eval/basicsr_metrics.py:61``)."""
    win = _gaussian_window()
    # scipy mode='nearest' == cv2 BORDER_REPLICATE
    filt = lambda x: correlate(x.astype(np.float64), win, mode='nearest')
    return float(np.mean(_ssim_map(img1.astype(np.float64),
                                   img2.astype(np.float64), filt,
                                   (0.01 * 255) ** 2, (0.03 * 255) ** 2)))


def _ssim_3d(img1: np.ndarray, img2: np.ndarray, max_value: float) -> float:
    """Colour SSIM: separable 11^3 gaussian over (H, W, C), replicate
    padding, in float32 as the reference's torch conv3d
    (``shiftnet_tpu/eval/basicsr_metrics.py:74``)."""
    k1 = _gaussian_1d()
    kernel3 = k1[:, None, None] * k1[None, :, None] * k1[None, None, :]
    filt = lambda x: correlate(x.astype(np.float32),
                               kernel3.astype(np.float32), mode='nearest')
    return float(np.mean(_ssim_map(img1.astype(np.float32),
                                   img2.astype(np.float32), filt,
                                   (0.01 * max_value) ** 2,
                                   (0.03 * max_value) ** 2)))


def calculate_ssim(img1, img2, crop_border: int = 0, input_order: str = 'HWC',
                   test_y_channel: bool = False) -> float:
    """``shiftnet_tpu/eval/basicsr_metrics.py:90``."""
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    img1 = reorder_image(np.asarray(img1), input_order).astype(np.float64)
    img2 = reorder_image(np.asarray(img2), input_order).astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
        return _ssim_y(img1[..., 0], img2[..., 0])
    max_value = 1 if img1.max() <= 1 else 255
    return _ssim_3d(img1, img2, max_value)
