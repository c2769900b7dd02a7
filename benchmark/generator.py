"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.
json``) and makes its inputs from ``--seed``, on the card in a few large
calls.

- ``restore`` mixes: a closed loop, one client, sending whole windows
  back to back.  A seeded pool of ``pool`` clips of ``frames`` x
  ``height`` x ``width`` frames in [0, 1] (cropped to multiples of
  ``mod_crop``, as the eval CLIs crop), served in turn from a seeded
  start.  ``sigmas_255``: the noise levels (on the 0-255 scale) that the
  denoise protocol adds, one per pool clip in this order from a seeded
  start, with the gaussian noise made here, in set-up.
- ``train`` mixes: one clip batch a step (``batch`` x ``frames`` x
  ``patch`` x ``patch``), each step's rows drawn anew from (seed, step),
  so that every step's batch differs and any step's can be made again.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


def derive(seed: int, *names) -> int:
    """A 63-bit seed for one stream of a run (weights, clips, a step's
    batch), from the run's seed and the stream's names."""
    key = ':'.join(str(v) for v in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], 'little') >> 1


def generator(seed: int, *names, device='cpu') -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *names))
    return g


@dataclasses.dataclass
class Unit:
    """One window of a restore mix: the clip (T, H, W, 3) float32 on the
    host, as the eval CLIs hand it to ``forward_window``, and its noise
    level in [0, 1] (None for deblurring)."""
    x: np.ndarray
    sigma: float | None


def restore_pool(traffic: dict, seed: int, device) -> list[Unit]:
    t, h, w = traffic['frames'], traffic['height'], traffic['width']
    m = traffic.get('mod_crop', 1)
    hc, wc = h - h % m, w - w % m
    sigmas = traffic.get('sigmas_255')
    n = traffic['pool']
    start = derive(seed, 'sigma') % len(sigmas) if sigmas else 0
    pool = []
    for i in range(n):
        g = generator(seed, 'clip', i, device=device)
        clip = torch.rand((t, h, w, 3), generator=g, device=device)
        clip = clip[:, :hc, :wc]
        sigma = None
        if sigmas:
            sigma = sigmas[(start + i) % len(sigmas)] / 255.0
            clip = clip + sigma * torch.randn(clip.shape, generator=g,
                                              device=device)
        pool.append(Unit(clip.cpu().numpy(), sigma))
        del clip
    return pool


def order(traffic: dict, seed: int, i: int) -> int:
    """The pool clip that unit ``i`` of the window sends."""
    return (derive(seed, 'order') + i) % traffic['pool']


def train_batch(traffic: dict, seed: int, step: int,
                device) -> dict[str, torch.Tensor]:
    """Step ``step``'s batch {'lq', 'gt'}: (B, T, 3, P, P) float32 in [0,
    1], made on the device."""
    g = generator(seed, 'batch', step, device=device)
    shape = (traffic['batch'], traffic['frames'], 3, traffic['patch'],
             traffic['patch'])
    return {k: torch.rand(shape, generator=g, device=device)
            for k in ('lq', 'gt')}
