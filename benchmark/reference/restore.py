"""The reference's restored window: the plan's tiles, each through the
plain float32 model on the device, stitched as the protocol stitches."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.model import Arch, Frames, GShiftNet, set_quant
from benchmark.reference.precision import matmul_precision
from benchmark.reference.window import tiles

HALO = 2


def build(arch: Arch, state: dict, device, quant=None) -> GShiftNet:
    """The plain model with ``state`` (raw weights, the program's keys)."""
    model = GShiftNet(arch)
    model.load_state_dict({k: v.float() for k, v in state.items()},
                          strict=True)
    set_quant(model, quant)
    return model.to(device).eval()


@torch.no_grad()
def restore(model: GShiftNet, x: np.ndarray, sigma: float | None, plan: str,
            *, block: int = 8, tf32: bool = False) -> torch.Tensor:
    """(T, H, W, 3) in [0, 1] -> (T - 2*HALO, H, W, 3) float32 on the
    model's device, on ``plan``'s tiles; ``sigma``: the noise map's
    constant where the model takes one."""
    dev = next(model.parameters()).device
    t, h, w, _ = x.shape
    out = torch.zeros((t - 2 * HALO, h, w, 3), device=dev)
    frames = Frames(block)
    with matmul_precision(tf32):
        for in_sl, crop_sl, out_sl in tiles(plan, h, w):
            xt = torch.from_numpy(np.ascontiguousarray(
                x[:, in_sl[0], in_sl[1]], np.float32)).to(dev)
            xt = xt.permute(0, 3, 1, 2).contiguous()
            nm = None
            if model.a.noise_map:
                nm = torch.full((t, 1, *xt.shape[2:]), float(sigma),
                                device=dev)
            y = model(xt, nm, frames)
            del xt, nm
            y = y.permute(0, 2, 3, 1)
            out[:, out_sl[0], out_sl[1]] = y[:, crop_sl[0], crop_sl[1]]
            del y
    return out
