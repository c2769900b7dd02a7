"""MATLAB-compatible bicubic imresize, on numpy in float64.

The port's own copy of ``shiftnet_tpu/eval/imresize.py:15-86``, the surface
of the reference's ``basicsr/utils/matlab_functions.py:12-176`` (itself a
port of MATLAB's imresize): a separable cubic kernel, antialiased on
downscale, symmetric boundary extension, weights normalized per row.
"""
from __future__ import annotations

import math

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _weights_indices(in_len: int, out_len: int, scale: float,
                     antialiasing: bool):
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2
    indices = left[:, None] + np.arange(p)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]
    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_len)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights, indices, sym_len_s, sym_len_e


def _sym_pad(img: np.ndarray, axis: int, before: int,
             after: int) -> np.ndarray:
    n = img.shape[axis]
    idx_before = np.arange(before - 1, -1, -1) if before else np.arange(0)
    idx_after = np.arange(n - 1, n - after - 1, -1) if after else np.arange(0)
    idx = np.concatenate([idx_before, np.arange(n), idx_after])
    return np.take(img, idx, axis=axis)


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) float or uint8 image by ``scale``
    (MATLAB bicubic); float64 out for float in, as the reference
    (``shiftnet_tpu/eval/imresize.py:59``)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w, c = img.shape
    out_h = math.ceil(in_h * scale)
    out_w = math.ceil(in_w * scale)
    x = img.astype(np.float64)

    wh, ih, ss_h, se_h = _weights_indices(in_h, out_h, scale, antialiasing)
    ww, iw, ss_w, se_w = _weights_indices(in_w, out_w, scale, antialiasing)

    xp = _sym_pad(x, 0, ss_h, se_h)
    # rows: out1[o] = sum_k wh[o, k] * xp[ih[o, k]]
    out1 = np.einsum('ok,okwc->owc', wh, xp[ih])

    out1p = _sym_pad(out1, 1, ss_w, se_w)
    # columns: out2[:, o] = sum_k ww[o, k] * out1p[:, iw[o, k]]
    out2 = np.einsum('wk,hwkc->hwc', ww, out1p[:, iw])

    if squeeze:
        out2 = out2[:, :, 0]
    if img.dtype == np.uint8:
        return np.clip(np.round(out2), 0, 255).astype(np.uint8)
    return out2
