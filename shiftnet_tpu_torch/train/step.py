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

On a mesh of ranks (``parallel/mesh.py``) the step is the global batch's:

- **data parallelism** (``shard_train_step``, ``step.py:101``): each data
  rank runs its clips;
- **sequence parallelism** (``make_tsharded_train_step``,
  ``step.py:125-271``): each rank of a time ring runs its frames of the
  ring's clips on a model built with the ring (``cfg.time_group``,
  ``past_frames = future_frames = 0``) and masks the global edge frames.

Either way each loss term is summed over all ranks and divided by the
global count, and the gradients are summed over all ranks (for a data
axis alone, DDP's average of the ranks' means), so they are the global
loss's before optax's clip reads their global norm.  Denoise draws the global batch's noise on every rank
from the step's generator and keeps its own clips and frames, so the
sharded step draws what the single one draws (``step.py:222-231``); HEM's
random mask draws from ``loss_generator``, which the trainer keys by
(seed, step, data rank, time rank) on a mesh, as JAX folds in both
indices.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

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
               generator: torch.Generator | None,
               shape: tuple | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-clip sigma (B,) ~ U(sigma_range) and noise N(0, 1) * sigma of
    ``shape`` (default gt's; the global batch's on a mesh), on gt's
    device, in gt's type (``shiftnet_tpu/train/step.py:62-67``)."""
    shape = tuple(gt.shape if shape is None else shape)
    b = shape[0]
    lo, hi = task.sigma_range
    u = torch.rand((b,), generator=generator, device=gt.device)
    sigma = lo + (hi - lo) * u
    noise = torch.randn(shape, generator=generator, device=gt.device,
                        dtype=gt.dtype) * sigma.view(b, 1, 1, 1, 1)
    return sigma, noise


def train_step(model, optimizer, task: TaskConfig,
               batch: dict[str, torch.Tensor],
               generator: torch.Generator | None,
               draws: tuple[torch.Tensor, torch.Tensor] | None = None, *,
               mesh=None, loss_generator: torch.Generator | None = None
               ) -> dict[str, torch.Tensor]:
    """Forward, loss, backward and one optimizer update.  ``draws``:
    denoise's (sigma, noise) of this rank's clips and frames, else drawn
    from ``generator``.  ``mesh``: the ranks' ``parallel.mesh.Mesh`` (None:
    one process); ``batch`` then holds this data rank's clips, whole (every
    rank of a time ring loads the same clips).  ``loss_generator``: HEM's
    draws (default ``generator``).  Returns the global loss and the
    unclipped global gradient norm as device scalars.

    On a time ring (``make_tsharded_train_step``, ``shiftnet_tpu/train/
    step.py:125-271``) the rank runs frames ``[lo, lo + t/time)`` on a
    model that predicts all of them and masks the frames outside the
    global center slice (``step.py:162-214``); otherwise the model trims
    the slice itself.  Either way each loss term's sum is taken over all
    ranks and divided by the global count (``optim.build_loss``), and the
    gradients are summed over all ranks, which for a data axis alone is
    DDP's average of the ranks' means."""
    gt = batch['gt']
    b, t = gt.shape[:2]
    fb, ff = task.center_slice
    ranks = 1 if mesh is None else mesh.size
    data, time = (1, 1) if mesh is None else (mesh.data, mesh.time)
    if time > 1 and (model.cfg.time_group is None or model.cfg.past_frames
                     or model.cfg.future_frames):
        raise ValueError('sequence parallelism needs a model on the time '
                         'ring with past_frames = future_frames = 0')
    if t % time:
        raise ValueError(f'{t} frames do not split over {time} ranks')
    t_loc = t // time
    lo = 0 if time == 1 else mesh.time_rank * t_loc
    frames = slice(lo, lo + t_loc)
    noise_map = None
    if task.kind == 'denoise':
        sigma, noise = draws if draws is not None else _draws(
            gt, task, generator, mesh, frames)
        lq = gt[:, frames] + noise
        noise_map = sigma.to(gt.dtype).view(b, 1, 1, 1, 1).expand(
            b, t_loc, 1, *gt.shape[3:])
    else:
        lq = batch['lq'][:, frames]
    optimizer.zero_grad(set_to_none=True)
    out = torch.stack([
        model(lq[i].to(task.dtype),
              None if noise_map is None else noise_map[i])
        for i in range(b)])
    mask = None
    if time > 1:
        target = gt[:, frames]
        g = torch.arange(lo, lo + t_loc, device=gt.device)
        mask = ((g >= fb) & (g < t - ff)).float().view(1, t_loc, 1, 1, 1)
    else:
        target = gt[:, fb:t - ff]
    count = (t - fb - ff) * b * data * math.prod(gt.shape[2:])
    loss = build_loss(task.loss_spec)(
        out.float(), target.float(),
        generator if loss_generator is None else loss_generator,
        mask=mask, count=count,
        reduce=dist.all_reduce if ranks > 1 else None)
    loss.backward()
    if ranks > 1:
        reduce_grads(model)
    gnorm = optimizer.step()
    return {'loss': loss.detach(), 'grad_norm': gnorm}


def shard_generator(seed: int, step: int, mesh,
                    device) -> torch.Generator | None:
    """HEM's draws on a mesh of more than one rank: keyed by (seed, step,
    data rank, time rank), as JAX folds both indices into the loss key
    (``step.py:190-194``); None (the step's generator) on one rank."""
    if mesh is None or mesh.size == 1:
        return None
    key = np.random.SeedSequence([seed, step, mesh.data_rank,
                                  mesh.time_rank])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key.generate_state(1, np.uint64)[0]))
    return gen


def _draws(gt, task, generator, mesh, frames):
    """This rank's denoise draws: the global batch's, drawn alike on
    every rank, cut to the data rank's clips and the given frames."""
    if mesh is None or mesh.data == 1:
        sigma, noise = draw_noise(gt, task, generator)
    else:
        b = gt.shape[0]
        sigma, noise = draw_noise(gt, task, generator,
                                  (b * mesh.data, *gt.shape[1:]))
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        sigma, noise = sigma[rows], noise[rows]
    return sigma, noise[:, frames]


def reduce_grads(model) -> None:
    """Sum every parameter's gradient over all ranks, one collective over
    one flat buffer; a parameter without a gradient counts as a zero one,
    as in AdamW."""
    params = list(model.parameters())
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in params])
    dist.all_reduce(flat)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p)
        off += n
