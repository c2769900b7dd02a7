"""The training cells: ``train_step`` (forward, loss, backward, clip,
AdamW) on seeded batches made on the device, one step a unit.  Set-up
builds the step's one model and optimizer, drives them through the first
``check_steps`` steps by the window's own call and feed, and records what
the comparison reads (each step's loss, the first gradient as the
optimizer holds it, the parameters' change over those steps); the window
then carries on from there."""
from __future__ import annotations

import statistics

import torch

from benchmark import generator, harness, weights
from benchmark.flops import train_step_flops
from benchmark.reference import train as ref
from benchmark.reference.model import Arch, CALayer, GShiftNet, set_quant

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}

# A channel attention's gate (the ReLU after its squeeze conv) whose input
# in the reference comes within this share of the input's RMS of its kink
# can fall on the other side in the program's rounding: bfloat16 flipped
# gates up to 0.022 of the RMS from the kink (PERF.md).
KINK = 0.05


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf(got: dict[str, float], want: dict[str, float], keys,
               label: str) -> float:
    """The worst leaf's gap of norms, |got - want| / max(want, the median
    leaf's), over ``keys``; the three worst and the median logged."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    gaps = sorted(((abs(got[k] - want[k]) / max(want[k], med, 1e-30), k)
                   for k in keys), reverse=True)
    harness.log(f'check: {label}: worst leaves ' + ', '.join(
        f'{k} {g:.4g} ({got[k]:.4g} vs {want[k]:.4g})'
        for g, k in gaps[:3]) + f'; median leaf norm {med:.4g}, median '
        f'gap {statistics.median(g for g, _ in gaps):.4g}')
    return gaps[0][0]


def kink_watch(model) -> dict[str, list[torch.Tensor]]:
    """Hooks on every channel attention's gate that collect, call by call,
    how near its input comes to the kink: min |z| / RMS(z).  Returns
    {attention's name: [readings]}, filled as the model runs."""
    seen: dict[str, list[torch.Tensor]] = {}
    for name, m in model.named_modules():
        if isinstance(m, CALayer):
            def hook(_, args, name=name):
                z = args[0].detach().float()
                seen.setdefault(name, []).append(
                    (z.abs() / z.square().mean().sqrt().clamp(min=1e-30))
                    .min())
            m.conv_du[1].register_forward_pre_hook(hook)
    return seen


def near_kink(seen: dict[str, list[torch.Tensor]]) -> set[str]:
    """The squeeze convs' leaves of the attentions whose gate came within
    ``KINK`` of its kink."""
    return {f'{name}.conv_du.0.{leaf}' for name, zs in seen.items()
            if float(torch.stack(zs).min()) < KINK
            for leaf in ('weight', 'bias')}


def _half_batch(out, lq, target):
    """Half of the supervised frames left out, the mean over the rest."""
    half = out.shape[1] // 2
    return out[:, :half], target[:, :half]


def _altered(out, lq, target):
    """The first supervised frame's answer left as its input."""
    fb = (lq.shape[1] - out.shape[1]) // 2  # the center is symmetric
    out = torch.cat([lq[:, fb:fb + 1], out[:, 1:]], dim=1)
    return out, target


# Faults planted in the reference put in the program's place: the model's
# answers altered before the loss, or ('stage_lost') the update of one
# stage of the model lost where the optimizer produces it.
FAULTS = {'half_batch': _half_batch, 'altered': _altered, 'stage_lost': None}


def lost_stage(names, seed: int) -> str:
    """The top-level module whose update the 'stage_lost' fault drops,
    drawn from the seed."""
    stages = sorted({k.split('.')[0] for k in names})
    return stages[generator.derive(seed, 'stage_lost') % len(stages)]


class Train:
    rate_metric = 'train_fps'
    span = 'train_step'

    def __init__(self, cell, seed: int, device, workdir: str | None,
                 program: bool = True):
        """Set-up: the seeded weights and (``program``) the step's model
        and optimizer driven through the first ``check_steps`` steps.
        Without ``program`` only the weights are made (the controls)."""
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.arch = Arch.from_config(cfg['model'])
        self.center = (self.arch.past_frames, self.arch.future_frames)
        self.frames_per_unit = tr['frames'] * tr['batch']
        self.dtype = DTYPES[cfg['precision']['train']]
        if not program:
            shapes = {k: tuple(v.shape) for k, v in
                      GShiftNet(self.arch).state_dict().items()}
            self.state = weights.make_state(shapes, seed, device)
            self.numel = {k: v.numel() for k, v in self.state.items()}
            return
        from shiftnet_tpu_torch.models import build_model
        from shiftnet_tpu_torch.train.optim import (OptimConfig,
                                                    build_optimizer)
        from shiftnet_tpu_torch.train.step import TaskConfig, train_step
        self._train_step = train_step
        self.model = build_model(cfg['variant'], fused_chw=tr['fused'],
                                 **cfg['model'])
        shapes = {k: tuple(v.shape) for k, v in
                  self.model.state_dict().items()}
        self.state = weights.make_state(shapes, seed, device)
        self.numel = {k: v.numel() for k, v in self.state.items()}
        self.model.load_state_dict(self.state, strict=True)
        self.model.to(device)
        self.task = TaskConfig(
            kind='denoise' if self.arch.noise_map else 'deblur',
            loss_spec=tr['loss'], center_slice=self.center, dtype=self.dtype)
        self.opt = build_optimizer(self.model, OptimConfig(**tr['optim']))
        self.gen = generator.generator(seed, 'draws', device=device)
        self.losses = []
        self.step = 0
        b1 = self.opt.param_groups[0]['betas'][0]
        for i in range(tr['check_steps']):
            self._step()
            self.losses.append(float(self.last['loss']))
            if i == 0:  # the clipped gradient, from Adam's first moment
                self.gnorm1 = float(self.last['grad_norm'])
                self.grad1 = leaf_norms(
                    {k: self.opt.state[p]['mu'] / (1 - b1)
                     for k, p in self.model.named_parameters()})
        self.change = leaf_norms(
            {k: p.detach() - self.state[k]
             for k, p in self.model.named_parameters()})
        harness.log(f'{cell.name}: T={tr["frames"]} patch {tr["patch"]} '
                    f'batch {tr["batch"]}, {self.task.dtype}, '
                    f'{"fused" if tr["fused"] else "unfused"}; losses '
                    f'{self.losses}')
        harness.sync(device)

    def _step(self) -> None:
        batch = generator.train_batch(self.tr, self.seed, self.step,
                                      self.device)
        self.last = self._train_step(self.model, self.opt, self.task, batch,
                                     self.gen)
        self.step += 1

    def unit(self, i: int) -> None:
        self._step()

    def release(self) -> None:
        del self.model, self.opt, self.last

    def reference_steps(self, quant=None, tf32: bool = False,
                        fault: str | None = None):
        """The reference's first ``check_steps`` steps from the same
        weights on the same batches: (losses, the first gradient's global
        norm before the clip, the first clipped gradient's leaf norms, the
        change's leaf norms, the leaves ``near_kink`` names over every
        step).  ``quant``, ``tf32``: the control's
        precision; ``fault``: a fault planted in the reference put in the
        program's place ('half_batch': the loss over half the supervised
        frames; 'altered': the first supervised frame's answer left as its
        input; 'stage_lost': one stage's update lost, ``lost_stage``)."""
        if self.arch.noise_map:
            raise NotImplementedError('the reference trains deblurring only')
        model = GShiftNet(self.arch)
        model.load_state_dict(self.state, strict=True)
        set_quant(model, quant)
        model.to(self.device).train()
        seen = kink_watch(model)
        o = self.tr['optim']
        opt = ref.Adam(model.parameters(), lr=o['lr'], betas=tuple(
            o['betas']), eps=1e-8, weight_decay=o['weight_decay'],
            t_max=o['scheduler_kwargs']['T_max'], eta_min=o['eta_min'],
            clip=o['grad_clip'])
        names = [k for k, _ in model.named_parameters()]
        keep = {}
        if fault == 'stage_lost':
            stage = lost_stage(names, self.seed)
            keep = {p: p.detach().clone() for k, p in
                    model.named_parameters() if k.split('.')[0] == stage}
        losses, grad1, gnorm1 = [], None, None
        for i in range(self.tr['check_steps']):
            b = generator.train_batch(self.tr, self.seed, i, self.device)
            loss, grads, gnorm = ref.step(model, opt, b['lq'], b['gt'],
                                          self.center, tf32=tf32,
                                          transform=FAULTS.get(fault))
            with torch.no_grad():
                for p, v in keep.items():
                    p.copy_(v)
            losses.append(loss)
            if i == 0:
                grad1 = leaf_norms(dict(zip(names, grads)))
                gnorm1 = gnorm
        change = leaf_norms({k: p.detach() - self.state[k]
                             for k, p in model.named_parameters()})
        return losses, gnorm1, grad1, change, near_kink(seen)

    def check(self, control: bool = False, quant=None, tf32: bool = False,
              fault: str | None = None) -> dict[str, float]:
        """The program's first steps against the reference's, by the worst
        leaf's gap of norms relative to max(the reference's leaf, the
        median leaf): ``grad_gap`` of the first clipped gradient (from
        Adam's state), ``change_gap`` of the parameters' change over the
        ``check_steps`` steps.  Left out of both, by rules on the reference
        whose causes PERF.md shows:

        - one-element leaves (PReLU slopes): each is one sum over every
          pixel of its layer that cancels, so its gap is that sum's
          rounding error whole;
        - the squeeze convs of the channel attentions whose gate input came
          within ``KINK`` of its kink in a reference step: the program's
          rounding can open a gate the reference keeps shut, which adds a
          whole frame's term to a row of that conv's gradient;
        - from the change, leaves whose reference gradient is under a
          thousandth of the median leaf's: they move by round-off alone.

        Logged beside them, not compared (PERF.md: no control or fault
        reads far enough above them): the first gradient's global norm
        before the clip, the first step's loss, the leaves left out.
        ``control``: the reference in the program's place, in the
        precision ``quant`` / ``tf32``, or with ``fault``."""
        w_loss, w_norm, w_grad, w_change, near = self.reference_steps()
        g_loss, g_norm, g_grad, g_change = (
            self.reference_steps(quant, tf32, fault)[:4] if control else
            (self.losses, self.gnorm1, self.grad1, self.change))
        med = statistics.median(w_grad.values())
        kept = [k for k in w_grad if self.numel[k] > 1 and k not in near]
        moved = [k for k in kept if w_grad[k] >= 1e-3 * med]
        harness.log(f'check: losses {g_loss} vs reference {w_loss} (first '
                    f'step gap {abs(g_loss[0] - w_loss[0]) / w_loss[0]:.4g}'
                    f'); gradient norms {g_norm} vs {w_norm} (gap '
                    f'{abs(g_norm - w_norm) / w_norm:.4g}); of '
                    f'{len(w_grad)} leaves left out: '
                    f'{sum(self.numel[k] == 1 for k in w_grad)} of one '
                    f'element, {len(near & set(w_grad))} squeeze convs '
                    f'near a kink, {len(kept) - len(moved)} more unmoved '
                    'from the change')
        out = [k for k in w_grad if k not in kept]
        if out:
            worst_leaf(g_grad, w_grad, out, 'gradient, leaves left out')
            worst_leaf(g_change, w_change, out, 'change, leaves left out')
        return {
            'grad_gap': worst_leaf(g_grad, w_grad, kept, 'gradient'),
            'change_gap': worst_leaf(g_change, w_change, moved, 'change'),
        }

    def flops(self, units: int) -> float:
        return units * train_step_flops(self.arch, self.tr['batch'],
                                        self.tr['frames'], self.tr['patch'],
                                        self.center)
