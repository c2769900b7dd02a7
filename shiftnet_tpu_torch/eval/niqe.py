"""NIQE, the Natural Image Quality Evaluator (a no-reference metric), on
numpy and scipy.

The port's own copy of ``shiftnet_tpu/eval/niqe.py:21-120``, the surface of
the reference's ``basicsr/metrics/niqe.py``: MSCN normalization, AGGD
feature fits over 96x96 blocks at two scales, the Mahalanobis distance to a
pristine multivariate gaussian.  The pristine statistics
(``data/niqe_pris_params.npz``, public data of the official NIQE release)
are the port's own copy of the JAX package's file, byte for byte; override
them with ``SHIFTNET_NIQE_PARAMS`` or ``params_path``.

The JAX package calls OpenCV for two steps; the machine the port runs on
has no OpenCV, so both are written out here in the arithmetic OpenCV does
on float32 (held equal to it on the CPU by ``tests/test_torch_validation.py``):
the half-size bilinear resize (``_half_linear``) and BGR to grey
(``_bgr2gray``).
"""
from __future__ import annotations

import math
import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as _gamma

from shiftnet_tpu_torch.eval.color import reorder_image, to_y_channel

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(_gamma(2.0 / _GAM)) / (_gamma(1.0 / _GAM)
                                          * _gamma(3.0 / _GAM))


def estimate_aggd_param(block: np.ndarray) -> tuple[float, float, float]:
    """Fit an asymmetric generalized gaussian to the block's coefficients
    (``shiftnet_tpu/eval/niqe.py:25``)."""
    block = block.flatten()
    left_std = np.sqrt(np.mean(block[block < 0] ** 2))
    right_std = np.sqrt(np.mean(block[block > 0] ** 2))
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2)
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    ratio = np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
    return alpha, left_std * ratio, right_std * ratio


def _block_features(block: np.ndarray) -> list[float]:
    feat = []
    alpha, bl, br = estimate_aggd_param(block)
    feat += [alpha, (bl + br) / 2]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        pair = block * np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = estimate_aggd_param(pair)
        mean = (br - bl) * (_gamma(2 / alpha) / _gamma(1 / alpha))
        feat += [alpha, mean, bl, br]
    return feat


def _half_linear(img: np.ndarray) -> np.ndarray:
    """``cv2.resize(img, (w // 2, h // 2), interpolation=INTER_LINEAR)`` of
    a float32 (H, W) image with even H and W: each output is its 2x2
    block, interpolated along W and then along H in OpenCV's ``a + (b - a)
    * 0.5`` form (halving is exact, so this rounds where OpenCV does)."""
    half = img.dtype.type(0.5)
    rows = img[:, 0::2] + (img[:, 1::2] - img[:, 0::2]) * half
    return rows[0::2] + (rows[1::2] - rows[0::2]) * half


def _fma32(x: np.ndarray, y: np.float32, z: np.ndarray) -> np.ndarray:
    # x * y is exact in float64 for float32 operands
    return (x.astype(np.float64) * np.float64(y) + z).astype(np.float32)


def _bgr2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` of a float32 (H, W, 3) BGR
    image, rounded as OpenCV's float32 path rounds it: each row in runs of
    8 pixels as ``fma(r, .299, fma(b, .114, g * .587))``; the row's last
    ``W % 8`` pixels one at a time, where in each whole group of 4 the
    first and third take ``fma(r, .299, fma(g, .587, b * .114))``."""
    b, g, r = (img[..., k].astype(np.float32) for k in range(3))
    cb, cg, cr = np.float32(0.114), np.float32(0.587), np.float32(0.299)
    out = _fma32(r, cr, _fma32(b, cb, g * cg))
    w = img.shape[1]
    tail = np.arange(w) - (w - w % 8)
    odd = (tail >= 0) & (tail < (w % 8) // 4 * 4) & (tail % 2 == 0)
    out[:, odd] = _fma32(r[:, odd], cr, _fma32(g[:, odd], cg,
                                               b[:, odd] * cb))
    return out


def niqe_core(img: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
              gaussian_window: np.ndarray, block: int = 96) -> float:
    """NIQE of a grey or Y image in [0, 255] float, shape (H, W)
    (``shiftnet_tpu/eval/niqe.py:51``)."""
    h, w = img.shape
    nbh, nbw = math.floor(h / block), math.floor(w / block)
    img = img[: nbh * block, : nbw * block]

    feats = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode='nearest')
        sigma = np.sqrt(np.abs(
            convolve(np.square(img), gaussian_window, mode='nearest')
            - mu ** 2))
        normalized = (img - mu) / (sigma + 1)
        scale_feats = []
        for iw in range(nbw):
            for ih in range(nbh):
                b = normalized[ih * block // scale:(ih + 1) * block // scale,
                               iw * block // scale:(iw + 1) * block // scale]
                scale_feats.append(_block_features(b))
        feats.append(np.array(scale_feats))
        if scale == 1:
            img = _half_linear(img / 255.0) * 255.0

    feats = np.concatenate(feats, axis=1)
    mu_dist = np.nanmean(feats, axis=0)
    cov_dist = np.cov(feats[~np.isnan(feats).any(axis=1)], rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = np.asarray(mu_pris - mu_dist).reshape(-1)
    return float(np.sqrt(d @ invcov @ d))


_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                       'niqe_pris_params.npz')


def load_pris_params(params_path: str | None = None):
    """The pristine statistics (mu, cov, window) of the official NIQE
    release: the port's copy beside this module, or ``params_path``, or
    ``SHIFTNET_NIQE_PARAMS`` (``shiftnet_tpu/eval/niqe.py:90``)."""
    path = params_path or os.environ.get('SHIFTNET_NIQE_PARAMS', _PARAMS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            'NIQE pristine-model statistics not found; set '
            'SHIFTNET_NIQE_PARAMS to a niqe_pris_params.npz from the official '
            f'NIQE release (tried {path})')
    data = np.load(path)
    return (data['mu_pris_param'], data['cov_pris_param'],
            data['gaussian_window'])


def calculate_niqe(img: np.ndarray, crop_border: int = 0,
                   input_order: str = 'HWC', convert_to: str = 'y',
                   params_path: str | None = None) -> float:
    """The reference's ``calculate_niqe`` (``niqe.py:164-211``;
    ``shiftnet_tpu/eval/niqe.py:104``) on a [0, 255] image."""
    mu_pris, cov_pris, window = load_pris_params(params_path)
    img = np.asarray(img).astype(np.float32)
    if input_order != 'HW':
        img = reorder_image(img, input_order)
        if convert_to == 'y':
            img = to_y_channel(img)
        elif convert_to == 'gray':
            img = _bgr2gray(img / 255.0) * 255.0
        img = np.squeeze(img)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe_core(img, mu_pris, cov_pris, window)
