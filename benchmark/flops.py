"""Model FLOPs of a unit of work, counted by ``torch.utils.flop_counter.
FlopCounterMode`` over the benchmark's plain reference on the meta device
(no memory, no arithmetic), at the exact shapes a unit runs: each tile of
a window as the plan runs it, with each RepConv merged as inference runs
it (the 3x3 branch and the identity folded into the kxk conv); a
training step's forward and backward, on the unmerged branches it
trains, without recompute."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from torch import nn

from benchmark.reference.model import Arch, GShiftNet, RepConv
from benchmark.reference.window import tiles


class _Merged(nn.Module):
    """A RepConv as inference runs it: its kxk conv alone, the 3x3 branch
    and the identity folded into it (same shapes, same output size)."""

    def __init__(self, rep: RepConv):
        super().__init__()
        self.conv = rep.conv_1

    def forward(self, x):
        return self.conv(x)


def _model(arch: Arch, merged: bool = False) -> GShiftNet:
    with torch.device('meta'):
        model = GShiftNet(arch)
    if merged:
        for parent in list(model.modules()):
            for name, child in parent.named_children():
                if isinstance(child, RepConv):
                    setattr(parent, name, _Merged(child))
    return model


def window_flops(arch: Arch, t: int, h: int, w: int, plan: str) -> int:
    """One (t, h, w) window's forward over ``plan``'s tiles, RepConvs
    merged."""
    model = _model(arch, merged=True)
    by_shape: dict[tuple[int, int], int] = {}
    total = 0
    for in_sl, _, _ in tiles(plan, h, w):
        shape = (len(range(h)[in_sl[0]]), len(range(w)[in_sl[1]]))
        if shape not in by_shape:
            x = torch.empty((t, 3, *shape), device='meta')
            nm = (torch.empty((t, 1, *shape), device='meta')
                  if arch.noise_map else None)
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                model(x, nm)
            by_shape[shape] = counter.get_total_flops()
        total += by_shape[shape]
    return total


def train_step_flops(arch: Arch, batch: int, t: int, patch: int,
                     center: tuple[int, int]) -> int:
    """One step's forward, L1 and backward (what autograd needs without
    recompute)."""
    model = _model(arch)
    x = torch.empty((t, 3, patch, patch), device='meta')
    counter = FlopCounterMode(display=False)
    with counter:
        for _ in range(batch):
            out = model(x)
            out.abs().mean().backward()
    return counter.get_total_flops()
