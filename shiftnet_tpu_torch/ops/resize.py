"""Resampling on ``(T, C, H, W)`` (counterpart of
``shiftnet_tpu/ops/resize.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_up2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False)``
    (half-pixel centers, edge clamp), computed in float32."""
    y = F.interpolate(x.float(), scale_factor=2, mode='bilinear',
                      align_corners=False)
    return y.to(x.dtype)


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Depth-to-space, torch channel order: (T, C*r*r, H, W) ->
    (T, C, H*r, W*r)."""
    return F.pixel_shuffle(x, scale)
