"""The reference's training step: L1 over the supervised frames, the
backward, optax's ``clip_by_global_norm``, then AdamW in optax's order
(``scale_by_adam``, decoupled weight decay, ``-lr``) with the torch cosine
schedule read at the update's count before the increment."""
from __future__ import annotations

import math

import torch

from benchmark.reference.model import Frames, GShiftNet
from benchmark.reference.precision import matmul_precision


def cosine(lr: float, t_max: int, eta_min: float, step: int) -> float:
    t = min(step, t_max)
    return eta_min + (lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t / t_max))


class Adam:
    """AdamW over ``params`` as optax chains it after the global-norm
    clip."""

    def __init__(self, params, *, lr, betas, eps, weight_decay, t_max,
                 eta_min, clip):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.wd, self.t_max, self.eta_min, self.clip = (weight_decay, t_max,
                                                        eta_min, clip)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> tuple[list[torch.Tensor], float]:
        """One update; returns the gradients as the update reads them
        (after the clip) and their global norm before the clip."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        if self.clip is not None and gnorm >= self.clip:
            grads = [g * (self.clip / gnorm).float() for g in grads]
        lr = cosine(self.lr, self.t_max, self.eta_min, self.count)
        self.count += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            p.add_(upd, alpha=-lr)
        return grads, float(gnorm)


def l1(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (out - target).abs().mean()


def step(model: GShiftNet, opt: Adam, lq: torch.Tensor, gt: torch.Tensor,
         center: tuple[int, int], *, tf32: bool = False, transform=None
         ) -> tuple[float, list[torch.Tensor], float]:
    """One step on a (B, T, 3, H, W) batch; returns the loss, the clipped
    gradients and the global gradient norm before the clip.
    ``transform(out, lq, target) -> (out, target)``, applied before the
    loss, plants a fault (the benchmark's checks of its own comparison)."""
    fb, ff = center
    t = gt.shape[1]
    for p in model.parameters():
        p.grad = None
    frames = Frames(remat=True)
    with matmul_precision(tf32):
        out = torch.stack([model(lq[i], None, frames)
                           for i in range(lq.shape[0])])
        target = gt[:, fb:t - ff]
        if transform is not None:
            out, target = transform(out, lq, target)
        loss = l1(out, target)
        loss.backward()
    grads, gnorm = opt.step()
    return float(loss.detach()), grads, gnorm
