"""Grouped spatial-temporal shift (GSTS) ops on ``(T, C, H, W)`` clips.

Counterpart of ``shiftnet_tpu/ops/shift.py``; the channel axis is 1 here.

- ``temporal_channel_shift`` moves half the channels one frame forward (or
  back), rotating the channel order within each frame as the reference's
  roll over the flattened ``(T*C)`` axis does
  (``gshift_deblur1.py:504-528``):

      forward: y[t] = cat(x[t-1][C/2:], x[t][:C/2])  (frame 0 wraps to x[T-1])
      reverse: y[t] = cat(x[t][C/2:], x[t+1][:C/2])  (frame T-1 wraps to x[0])

  ``boundary_patch`` restores the wrapped frame to its input.
- ``grouped_spatial_shift`` translates 24 channel groups by static
  (dy, dx) offsets in {0, +-4, +-8} with zero fill
  (``gshift_deblur1.py:470-503``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# 24 direction groups: (dy, dx) with out[y, x] = in[y - dy, x - dx], zero
# fill.  The 16 outer groups have n2 = (number-1)//2 channels each, the 8
# inner ones n1 = number - 2*n2.
SHIFT_DIRS_OUTER = (
    (8, 8), (8, 4), (8, 0), (8, -4), (8, -8),
    (-8, 8), (-8, 4), (-8, 0), (-8, -4), (-8, -8),
    (4, 8), (4, -8), (0, 8), (0, -8), (-4, 8), (-4, -8),
)
SHIFT_DIRS_INNER = (
    (4, 4), (4, 0), (4, -4), (0, 4), (0, -4), (-4, 4), (-4, 0), (-4, -4),
)
MAX_SHIFT = 8


def shift_group_channels(number: int) -> tuple[int, int]:
    """Channels per (outer, inner) direction group for ``number``."""
    n2 = (number - 1) // 2
    return n2, number - 2 * n2


def shift_dir_table(number: int) -> list[tuple[int, int, int, int]]:
    """(c_start, c_size, dy, dx) for each group, covering 8*number channels."""
    n2, n1 = shift_group_channels(number)
    table = []
    c = 0
    for dy, dx in SHIFT_DIRS_OUTER:
        table.append((c, n2, dy, dx))
        c += n2
    for dy, dx in SHIFT_DIRS_INNER:
        table.append((c, n1, dy, dx))
        c += n1
    assert c == 8 * number
    return table


def grouped_spatial_shift(hw: torch.Tensor, number: int) -> torch.Tensor:
    """Shift each channel group of ``hw`` (T, 8*number, H, W) by its static
    offset, zero-filled at the borders (pure copies: bit-exact)."""
    _, c, h, w = hw.shape
    if c != 8 * number:
        raise ValueError(f'grouped_spatial_shift: {c} channels for number '
                         f'{number}')
    s = MAX_SHIFT
    padded = F.pad(hw, (s, s, s, s))
    parts = [padded[:, c0:c0 + csz, s - dy:s - dy + h, s - dx:s - dx + w]
             for c0, csz, dy, dx in shift_dir_table(number) if csz]
    return torch.cat(parts, dim=1)


def temporal_channel_shift(x: torch.Tensor, *, reverse: bool = False,
                           boundary_patch: bool = True) -> torch.Tensor:
    """Temporal half-channel shift over the frame axis (see module doc)."""
    c = x.shape[1]
    cs = c // 2
    if not reverse:
        y = torch.cat([torch.roll(x[:, c - cs:], 1, dims=0), x[:, :c - cs]],
                      dim=1)
        if boundary_patch:
            y[0] = x[0]
    else:
        y = torch.cat([x[:, cs:], torch.roll(x[:, :cs], -1, dims=0)], dim=1)
        if boundary_patch:
            y[-1] = x[-1]
    return y


def gsts(x: torch.Tensor, number: int, *, reverse: bool = False,
         boundary_patch: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """One GSTS round: the temporally shifted y (T, C, H, W) and hw, the
    spatially shifted copy of the moved channels (front 8*number going
    forward, back 8*number in reverse).  The reference concatenates them
    (``gshift_deblur1.py:504-528``); CAB2 takes them apart."""
    y = temporal_channel_shift(x, reverse=reverse,
                               boundary_patch=boundary_patch)
    add_c = 8 * number
    hw = y[:, -add_c:] if reverse else y[:, :add_c]
    return y, grouped_spatial_shift(hw, number)
