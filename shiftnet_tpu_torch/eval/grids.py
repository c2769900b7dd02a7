"""Overlap-averaged crop tiling with rotation / flip test-time augmentation,
the reference's validation protocol, on numpy.

The port's own copy of ``shiftnet_tpu/eval/grids.py:20-85``, the
reference's ``grids`` / ``grids_inverse`` / ``transpose``
(``basicsr/models/image_restoration_model.py:161-252``): ``crop_size``
tiles at adaptive strides cover the frame, each optionally transformed by
one of 8 rot90 / flip transforms; the predictions are transformed back and
averaged by how many tiles cover each pixel.  Clips are (T, H, W, C).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridPlan:
    i: int
    j: int
    trans_idx: int


def transpose_fwd(x: np.ndarray, trans_idx: int) -> np.ndarray:
    """rot90 ``trans_idx % 4`` times over (H, W), after a W flip when
    ``trans_idx >= 4`` (``shiftnet_tpu/eval/grids.py:27``).  Returns a view,
    with negative strides for most transforms."""
    if trans_idx >= 4:
        x = x[:, :, ::-1]
    return np.rot90(x, trans_idx % 4, axes=(1, 2))


def transpose_inv(x: np.ndarray, trans_idx: int) -> np.ndarray:
    """The inverse of ``transpose_fwd``, contiguous
    (``shiftnet_tpu/eval/grids.py:35``)."""
    x = np.rot90(x, 4 - trans_idx % 4, axes=(1, 2))
    if trans_idx >= 4:
        x = x[:, :, ::-1]
    return np.ascontiguousarray(x)


def plan_grids(h: int, w: int, crop_size: int,
               trans_num: int = 1) -> list[GridPlan]:
    """The reference's ``grids`` tile plan (:175-222): adaptive steps, so
    that the last tile lies flush with the border
    (``shiftnet_tpu/eval/grids.py:42``)."""
    num_row = (h - 1) // crop_size + 1
    num_col = (w - 1) // crop_size + 1
    step_j = crop_size if num_col == 1 else math.ceil(
        (w - crop_size) / (num_col - 1) - 1e-8)
    step_i = crop_size if num_row == 1 else math.ceil(
        (h - crop_size) / (num_row - 1) - 1e-8)

    plans = []
    i, last_i = 0, False
    while i < h and not last_i:
        if i + crop_size >= h:
            i, last_i = h - crop_size, True
        j, last_j = 0, False
        while j < w and not last_j:
            if j + crop_size >= w:
                j, last_j = w - crop_size, True
            for t in range(trans_num):
                plans.append(GridPlan(i, j, t))
            j += step_j
        i += step_i
    return plans


def extract_grids(clip: np.ndarray, plans: list[GridPlan],
                  crop_size: int) -> list[np.ndarray]:
    """The planned crops of a (T, H, W, C) clip, each transformed
    (``shiftnet_tpu/eval/grids.py:68``)."""
    return [transpose_fwd(
        clip[:, p.i:p.i + crop_size, p.j:p.j + crop_size], p.trans_idx)
        for p in plans]


def merge_grids(preds: list[np.ndarray], plans: list[GridPlan],
                out_shape: tuple[int, ...], crop_size: int) -> np.ndarray:
    """Transform back and average by coverage, the reference's
    ``grids_inverse`` (:238-252; ``shiftnet_tpu/eval/grids.py:76``)."""
    out = np.zeros(out_shape, np.float32)
    count = np.zeros(out_shape[:1] + out_shape[1:3] + (1,), np.float32)
    for pred, p in zip(preds, plans):
        restored = transpose_inv(np.asarray(pred, np.float32), p.trans_idx)
        out[:, p.i:p.i + crop_size, p.j:p.j + crop_size] += restored
        count[:, p.i:p.i + crop_size, p.j:p.j + crop_size] += 1.0
    return out / count
