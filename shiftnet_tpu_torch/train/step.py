"""One training step on the port.

Counterpart of ``shiftnet_tpu/train/step.py`` (``TaskConfig``,
``make_train_step``; the reference's trainer wrappers,
``basicsr/models/image_restoration{,1,2,3}_model.py``).  Deblur consumes
(lq, gt) pairs and supervises the center frames (``center_slice``);
denoise draws a per-clip sigma ~ U(0, 50/255) and gaussian noise on the
device inside the step (``step.py:50-98``), with a constant noise map.
The draws come from an explicit ``torch.Generator``; the trainer keys it by
step, as JAX folds the step into its key, so a resumed run draws what the
uninterrupted one would.

Batches are ``{'gt': (B, T, 3, H, W), 'lq': ...}`` float32 on the model's
device; each clip runs through the model on its own (JAX vmaps over B).
"""
from __future__ import annotations

import dataclasses

import torch

from shiftnet_tpu_torch.train.optim import build_loss


@dataclasses.dataclass
class TaskConfig:
    """What the step computes: 'deblur' (paired) or 'denoise' (synthetic
    noise).  ``dtype``: the forward's compute type (the parameters stay
    float32), which the JAX package sets on the model instead."""
    kind: str = 'deblur'
    loss_spec: str = '1*L1'
    sigma_range: tuple[float, float] = (0.0, 50.0 / 255.0)
    center_slice: tuple[int, int] = (1, 1)  # (past, future) frames trimmed
    dtype: torch.dtype = torch.float32


def draw_noise(gt: torch.Tensor, task: TaskConfig,
               generator: torch.Generator | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-clip sigma (B,) ~ U(sigma_range) and noise N(0, 1) * sigma of
    gt's shape, on gt's device (``shiftnet_tpu/train/step.py:62-67``)."""
    b = gt.shape[0]
    lo, hi = task.sigma_range
    u = torch.rand((b,), generator=generator, device=gt.device)
    sigma = lo + (hi - lo) * u
    noise = torch.randn(gt.shape, generator=generator, device=gt.device,
                        dtype=gt.dtype) * sigma.view(b, 1, 1, 1, 1)
    return sigma, noise


def train_step(model, optimizer, task: TaskConfig,
               batch: dict[str, torch.Tensor],
               generator: torch.Generator | None,
               draws: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> dict[str, torch.Tensor]:
    """Forward, loss, backward and one optimizer update.  ``draws``:
    denoise's (sigma, noise), else drawn from ``generator``.  Returns the
    loss and the unclipped global gradient norm as device scalars."""
    gt = batch['gt']
    b, t = gt.shape[:2]
    fb, ff = task.center_slice
    target = gt[:, fb:t - ff]
    noise_map = None
    if task.kind == 'denoise':
        sigma, noise = draws if draws is not None else draw_noise(
            gt, task, generator)
        lq = gt + noise
        noise_map = sigma.to(gt.dtype).view(b, 1, 1, 1, 1).expand(
            b, t, 1, *gt.shape[3:])
    else:
        lq = batch['lq']
    optimizer.zero_grad(set_to_none=True)
    out = torch.stack([
        model(lq[i].to(task.dtype),
              None if noise_map is None else noise_map[i])
        for i in range(b)])
    loss = build_loss(task.loss_spec)(out.float(), target.float(), generator)
    loss.backward()
    gnorm = optimizer.step()
    return {'loss': loss.detach(), 'grad_norm': gnorm}
