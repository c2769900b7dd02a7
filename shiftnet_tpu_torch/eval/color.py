"""Colour-space conversions matching MATLAB's rgb2ycbcr (ITU-R BT.601), on
numpy: the Y and YCbCr conversions of the Y-channel metric path.

The port's own copy of ``shiftnet_tpu/eval/color.py:11-70``
(``rgb2ycbcr``, ``bgr2ycbcr``, ``ycbcr2rgb``, ``to_y_channel``,
``reorder_image``), itself the surface of the reference's
``basicsr/utils/matlab_functions.py:179-310``.
"""
from __future__ import annotations

import numpy as np

_YCBCR = np.array([[65.481, -37.797, 112.0],
                   [128.553, -74.203, -93.786],
                   [24.966, 112.0, -18.214]])
_OFFSET = np.array([16.0, 128.0, 128.0])


def _to_unit(img: np.ndarray) -> tuple[np.ndarray, np.dtype]:
    dtype = img.dtype
    img = img.astype(np.float32)
    if dtype != np.uint8:
        if img.max() > 1.001:
            raise TypeError('float input should be in [0, 1]')
    else:
        img = img / 255.0
    return img, dtype


def _from_unit255(img: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint8:
        return img.round().astype(np.uint8)
    return (img / 255.0).astype(np.float32)


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """``shiftnet_tpu/eval/color.py:34``: uint8, or float in [0, 1]."""
    img, dtype = _to_unit(img)
    if y_only:
        out = img @ _YCBCR[:, 0] + _OFFSET[0]
    else:
        out = img @ _YCBCR + _OFFSET
    return _from_unit255(out, dtype)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """``shiftnet_tpu/eval/color.py:43``."""
    return rgb2ycbcr(img[..., ::-1], y_only=y_only)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """``shiftnet_tpu/eval/color.py:47``."""
    img, dtype = _to_unit(img)
    inv = np.linalg.inv(_YCBCR.T) * 255.0
    out = (img * 255.0 - _OFFSET) @ inv * 255.0
    return _from_unit255(out, dtype)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """``shiftnet_tpu/eval/color.py:54``, the reference's
    ``metric_util.to_y_channel``: [0, 255] BGR -> Y in [0, 255]."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0


def reorder_image(img: np.ndarray, input_order: str = 'HWC') -> np.ndarray:
    """``shiftnet_tpu/eval/color.py:63``: HWC (a 2-D image gains a
    channel axis)."""
    if input_order not in ('HWC', 'CHW'):
        raise ValueError(f'Wrong input_order {input_order}')
    if img.ndim == 2:
        return img[..., None]
    if input_order == 'CHW':
        return img.transpose(1, 2, 0)
    return img
