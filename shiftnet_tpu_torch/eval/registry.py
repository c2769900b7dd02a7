"""The validation metrics by name.

The port's own copy of ``shiftnet_tpu/eval/registry.py:20-65``, the
reference's by-name dispatch (``basicsr/metrics/__init__.py:7-10``,
``calculate_metric`` resolving ``opt['type']``) as its ``with_metrics``
validation loop uses it (``basicsr/models/image_restoration_model.py:
392-425``), where a config like

    val:
      metrics:
        psnr: {type: calculate_psnr, crop_border: 0, test_y_channel: false}
        niqe: {type: calculate_niqe, crop_border: 0}

runs every named metric on each validation output.  Every function takes
uint8-range HWC numpy images.
"""
from __future__ import annotations

from typing import Any, Callable

from shiftnet_tpu_torch.eval.basicsr_metrics import (calculate_psnr,
                                                     calculate_ssim)
from shiftnet_tpu_torch.eval.metrics import psnr, ssim
from shiftnet_tpu_torch.eval.niqe import calculate_niqe

# 'psnr' / 'ssim' are the inference-local protocol of the published numbers
# (``inference/test_deblur.py:25-49``: skimage PSNR, scipy-gaussian SSIM);
# 'calculate_*' are the BasicSR validation variants.
METRIC_FUNCS: dict[str, Callable] = {
    'psnr': psnr,
    'ssim': ssim,
    'calculate_psnr': calculate_psnr,
    'calculate_ssim': calculate_ssim,
    'calculate_niqe': calculate_niqe,
}

# The metrics that take only the restored image.
NO_REFERENCE = {'calculate_niqe'}


def calculate_metric(data: dict[str, Any], opt: dict[str, Any]) -> float:
    """The reference's ``basicsr.metrics.calculate_metric``: ``opt['type']``
    picks the function, the other keys are its keyword arguments, ``data``
    holds ``img`` and ``img2`` (``shiftnet_tpu/eval/registry.py:47``)."""
    opt = dict(opt)
    metric_type = opt.pop('type')
    fn = METRIC_FUNCS[metric_type]
    if metric_type in NO_REFERENCE:
        return float(fn(data['img'], **opt))
    return float(fn(data['img'], data['img2'], **opt))


def score_pair(img, gt, metrics: dict[str, dict[str, Any]]) -> dict[str, float]:
    """Every configured metric on one (restored, gt) pair; ``metrics``:
    {name: {'type': ..., **kwargs}}, the reference's ``val.metrics``
    (``shiftnet_tpu/eval/registry.py:58``)."""
    return {name: calculate_metric({'img': img, 'img2': gt}, mopt)
            for name, mopt in metrics.items()}
