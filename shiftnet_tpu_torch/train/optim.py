"""Optimizer, schedule and loss construction.

Counterpart of ``shiftnet_tpu/train/optim.py``.  Reference recipe
(``basicsr/models/image_restoration_model.py:112-141``,
``options/gopro_deblur.yml:59-72``): AdamW lr 4e-4, betas (0.9, 0.99),
weight_decay 0, cosine anneal to 1e-7, global-norm grad clip (0.01 deblur,
0.04 denoise-big), per-group LR multipliers (1.5x for
``stage1.decoder_level*`` in the denoise-big finetune recipe,
``image_restoration3_model.py:116-125``).

``AdamW`` follows the JAX package's optax chain, not ``torch.optim.AdamW``:
``clip_by_global_norm`` (scale by ``max_norm / g_norm`` only when ``g_norm
>= max_norm``; torch's ``clip_grad_norm_`` divides by ``g_norm + 1e-6``),
then per group ``scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate``, the schedule read at the update's count before
the increment (the first update uses ``schedule(0)``).  Group LR scales are
regexes over the flax parameter paths (``stage1/decoder_level``), matched
against each torch key's flax path (``flax_paths``).

Losses: ``Loss2`` spec strings (``"1*L1"``, ``"1*L1+2*HEM"``,
``basicsr/loss/__init__.py:104-170``) and hard-example-mining L1
(``basicsr/loss/hard_example_mining.py:14-47``), on ``(..., C, H, W)``
tensors; HEM's random mask draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable

import torch
from torch import nn

from shiftnet_tpu_torch.train.schedulers import Schedule, build_schedule


@dataclasses.dataclass
class OptimConfig:
    lr: float = 4e-4
    betas: tuple[float, float] = (0.9, 0.99)
    weight_decay: float = 0.0
    eps: float = 1e-8
    total_iters: int = 300_000
    eta_min: float = 1e-7
    scheduler_kind: str = 'cosine'
    scheduler_kwargs: dict = dataclasses.field(default_factory=dict)
    warmup_iter: int = -1
    grad_clip: float | None = 0.01
    # flax-path regex -> lr multiplier, e.g. {r'stage1/decoder_level': 1.5}
    lr_group_scales: dict[str, float] = dataclasses.field(default_factory=dict)


def cosine_lr(cfg: OptimConfig) -> Schedule:
    """The configured schedule (default: torch CosineAnnealingLR)."""
    return build_schedule(cfg.scheduler_kind, cfg.lr, cfg.total_iters,
                          eta_min=cfg.eta_min, warmup_iter=cfg.warmup_iter,
                          **cfg.scheduler_kwargs)


def flax_paths(model: nn.Module) -> dict[str, str]:
    """Each parameter's torch key -> its path in the JAX package's flax
    tree, '/'-joined: a Sequential index joins its container's name as
    ``name__i``, and a conv's weight / bias sit under the flax wrapper's
    ``conv`` as ``kernel`` / ``bias`` (the inverse of
    ``tools/convert.flax_path_to_torch_key``)."""
    from shiftnet_tpu_torch.models.layers import Conv2d
    out = {}
    for mod_name, mod in model.named_modules():
        parts: list[str] = []
        for comp in mod_name.split('.') if mod_name else []:
            if comp.isdigit():
                parts[-1] += f'__{comp}'
            else:
                parts.append(comp)
        for pname, _ in mod.named_parameters(recurse=False):
            leaf = ['conv', 'kernel' if pname == 'weight' else pname] if (
                isinstance(mod, Conv2d)) else [pname]
            key = f'{mod_name}.{pname}' if mod_name else pname
            out[key] = '/'.join(parts + leaf)
    return out


def param_groups(model: nn.Module,
                 scales: dict[str, float]) -> list[dict]:
    """Param groups labelled as optax's ``multi_transform`` labels the JAX
    tree: each parameter by the first regex of ``scales`` that matches its
    flax path (``re.search``), else the default group (scale 1)."""
    paths = flax_paths(model)
    groups = {'': []}
    groups.update({pat: [] for pat in scales})
    for key, p in model.named_parameters():
        label = next((pat for pat in scales if re.search(pat, paths[key])),
                     '')
        groups[label].append((key, p))
    return [{'params': [p for _, p in members],
             'names': [k for k, _ in members],
             'label': label, 'lr_scale': float(scales.get(label, 1.0))}
            for label, members in groups.items() if members]


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float | None
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients scaled by ``max_norm /
    g_norm`` where ``g_norm >= max_norm``, else as they are; returns them
    and ``g_norm``, the unclipped global norm (a device scalar)."""
    gnorm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    if max_norm is None:
        return grads, gnorm
    scale = torch.where(gnorm < max_norm, 1.0, max_norm / gnorm)
    return torch._foreach_mul(grads, scale), gnorm


class AdamW(torch.optim.Optimizer):
    """The JAX package's optimizer (``optim.py:build_optimizer``) on torch
    param groups (``param_groups``): optax's global-norm clip over all
    gradients, then per group Adam moments, bias correction, decoupled
    weight decay and ``-schedule(count) * lr_scale``.  A parameter without
    a gradient counts as a zero gradient, as every leaf of the JAX tree
    has one.  The updates are in-place ``torch._foreach`` ops, which bump
    each parameter's version, so kernel weight panels kept on a parameter
    (``ops.chw._kept_panel``) are repacked after a step."""

    def __init__(self, groups: list[dict], cfg: OptimConfig):
        defaults = dict(betas=tuple(cfg.betas), eps=cfg.eps,
                        weight_decay=cfg.weight_decay, lr=cfg.lr,
                        lr_scale=1.0, count=0)
        super().__init__(groups, defaults)
        self.grad_clip = cfg.grad_clip
        self.schedule = cosine_lr(cfg)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        """One update; returns the unclipped global gradient norm (a
        float32 device scalar; no host sync)."""
        params = [p for g in self.param_groups for p in g['params']]
        grads, gnorm = clip_by_global_norm(
            [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params], self.grad_clip)
        i = 0
        for group in self.param_groups:
            ps = group['params']
            gs = grads[i:i + len(ps)]
            i += len(ps)
            self._update(group, ps, gs)
        return gnorm

    def _update(self, group, ps, gs):
        b1, b2 = group['betas']
        state = [self.state[p] for p in ps]
        for st, p in zip(state, ps):
            if not st:
                st['mu'] = torch.zeros_like(p)
                st['nu'] = torch.zeros_like(p)
        mu = [st['mu'] for st in state]
        nu = [st['nu'] for st in state]
        group['lr'] = self.schedule(group['count']) * group['lr_scale']
        group['count'] += 1
        n = group['count']
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, n))
        den = torch._foreach_div(nu, _bias_correction(b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group['eps'])
        upd = torch._foreach_div(mu_hat, den)
        if group['weight_decay']:
            torch._foreach_add_(upd, ps, alpha=group['weight_decay'])
        torch._foreach_add_(ps, upd, alpha=-group['lr'])


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta ** count`` in float32, as optax's ``scale_by_adam`` takes
    it (1 - 0.99 in float32 is 1e-6 off its float64 value)."""
    one = torch.tensor(1.0)
    return float(one - torch.tensor(beta) ** count)


def build_optimizer(model: nn.Module, cfg: OptimConfig) -> AdamW:
    return AdamW(param_groups(model, cfg.lr_group_scales), cfg)


# -- losses --------------------------------------------------------------------

def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def psnr_loss(pred, target):
    """``PSNRLoss`` (``basicsr/models/losses/losses.py:90-115``):
    0.5 * (10/ln10) * log(mean((p-t)^2) + 1e-8), minimized."""
    scale = 10.0 / math.log(10.0)
    return 0.5 * scale * torch.log(torch.mean(torch.square(pred - target))
                                   + 1e-8)


def hem_loss(pred, target, *, hard_thre_p: float = 0.5,
             random_thre_p: float = 0.1,
             generator: torch.Generator | None = None):
    """Hard-example-mining L1 (``hard_example_mining.py:14-47``) on
    ``(..., C, H, W)``: the mean of |x-y| * ``hem_mask`` over all
    elements."""
    err = torch.abs(pred - target)
    return torch.mean(err * hem_mask(err, hard_thre_p=hard_thre_p,
                                     random_thre_p=random_thre_p,
                                     generator=generator))


def hem_mask(err, *, hard_thre_p: float = 0.5, random_thre_p: float = 0.1,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """HEM's mask of ``err = |x-y|`` (``(..., C, H, W)``): the per-pixel
    residual (summed over channels) is thresholded at the value ranked
    ``hard_thre_p*h*w`` (descending, strictly greater), and an
    exactly-``random_thre_p*h*w``-pixel random mask drawn from
    ``generator`` is OR-ed in (none without a generator).  Leading dims are
    the mask batch (frames).  Returns ``(..., 1, H, W)`` in err's type."""
    h, w = err.shape[-2:]
    res = err.sum(dim=-3)                              # (..., H, W)
    flat = res.reshape(-1, h * w)
    k = int(hard_thre_p * h * w)
    thre = torch.sort(flat, dim=1, descending=True).values[:, k]
    mask = flat > thre[:, None]
    k2 = int(random_thre_p * h * w)
    if generator is not None and k2 > 0:
        rand = torch.rand(flat.shape, generator=generator,
                          device=flat.device)
        cutoff = torch.sort(rand, dim=1).values[:, k2 - 1]
        mask = mask | (rand <= cutoff[:, None])
    return mask.to(err.dtype).reshape(res.shape).unsqueeze(-3)


_LOSS_FNS: dict[str, Callable] = {
    'L1': l1_loss, 'MSE': mse_loss, 'L2': mse_loss, 'PSNR': psnr_loss,
    'HEM': hem_loss,
}


def parse_loss_spec(spec: str) -> list[tuple[float, str]]:
    """``"1*L1+2*HEM"`` -> [(1.0, 'L1'), (2.0, 'HEM')]."""
    terms = []
    for part in spec.split('+'):
        weight, name = part.split('*')
        name = name.strip()
        if name not in _LOSS_FNS:
            raise ValueError(f'unknown loss {name!r} in {spec!r}')
        terms.append((float(weight), name))
    return terms


def build_loss(spec: str) -> Callable:
    """A ``Loss2`` spec string as a callable ``(pred, target, generator=
    None, *, mask=None, count=None, reduce=None)``.

    Each term is a function of one sum S over the elements and of the
    count that the loss averages over: S of |d| (L1), d^2 (MSE, L2,
    PSNR) or |d| * ``hem_mask`` (HEM, its random part drawn from
    ``generator``), d = pred - target; L1, MSE and HEM are S / count,
    PSNR 0.5 * (10/ln10) * log(S / count + 1e-8).  ``mask`` weights the
    elements (0 or 1, broadcast over pred), ``count`` defaults to pred's
    elements.  ``reduce`` (ranks of a mesh) sums a tensor of the terms'
    sums over the ranks in place: each S is then the global sum, entering
    the loss as the rank's own sum plus a constant, so the loss is the
    global one and its backward gives each rank f'(S) dS_r, which summed
    over the ranks is the global loss's gradient
    (``shiftnet_tpu/train/step.py:162-214``)."""
    terms = parse_loss_spec(spec)
    scale = 0.5 * 10.0 / math.log(10.0)

    def loss_fn(pred, target, generator=None, *, mask=None, count=None,
                reduce=None):
        d = pred - target
        sums = []
        for _, name in terms:
            if name == 'L1':
                e = torch.abs(d)
            elif name == 'HEM':
                e = torch.abs(d)
                e = e * hem_mask(e, generator=generator)
            else:
                e = torch.square(d)
            sums.append(torch.sum(e if mask is None else e * mask))
        if reduce is not None:
            total = torch.stack([v.detach() for v in sums])
            reduce(total)
            sums = [t + (v - v.detach()) for t, v in zip(total, sums)]
        n = pred.numel() if count is None else count
        loss = 0.0
        for (w, name), v in zip(terms, sums):
            mean = v / n
            loss = loss + w * (scale * torch.log(mean + 1e-8)
                               if name == 'PSNR' else mean)
        return loss

    return loss_fn
