"""Channel LayerNorm on ``(T, C, H, W)`` (counterpart of
``shiftnet_tpu/ops/norm.py``; reference ``LayerNorm2d``,
``gshift_deblur1.py:17-53``)."""
from __future__ import annotations

import torch


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Normalize over the channel axis with biased variance, eps inside the
    square root; statistics in float32, result in x's type."""
    x32 = x.float()
    mu = x32.mean(dim=1, keepdim=True)
    xc = x32 - mu
    var = xc.square().mean(dim=1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float()[:, None, None] + bias.float()[:, None, None]
    return y.to(x.dtype)
