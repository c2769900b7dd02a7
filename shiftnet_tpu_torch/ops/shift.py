"""Grouped spatial-temporal shift (GSTS) ops on ``(T, C, H, W)`` clips.

Counterpart of ``shiftnet_tpu/ops/shift.py``; the channel axis is 1 here.

- ``temporal_channel_shift`` moves half the channels one frame forward (or
  back), rotating the channel order within each frame as the reference's
  roll over the flattened ``(T*C)`` axis does
  (``gshift_deblur1.py:504-528``):

      forward: y[t] = cat(x[t-1][C/2:], x[t][:C/2])  (frame 0 wraps to x[T-1])
      reverse: y[t] = cat(x[t][C/2:], x[t+1][:C/2])  (frame T-1 wraps to x[0])

  ``boundary_patch`` restores the wrapped frame to its input.  With a
  ``group`` (sequence parallelism: the clip's frames split over a time
  ring of ranks, ``parallel/temporal.py``) the frame that crosses a shard
  boundary comes from the neighbouring rank, and only the global boundary
  frame is patched (``shiftnet_tpu/ops/shift.py:158-193``).
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
                           boundary_patch: bool = True,
                           group=None) -> torch.Tensor:
    """Temporal half-channel shift over the frame axis (see module doc).
    ``group``: the time ring over which x's frames are split; None for a
    whole clip."""
    if group is not None:
        return _temporal_channel_shift_sharded(x, reverse, boundary_patch,
                                               group)
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


def _temporal_channel_shift_sharded(x, reverse, boundary_patch, group):
    """The shift on this rank's frames of a clip split over ``group``:
    one edge frame's moving half-channels go to the neighbour over the
    ring (``parallel.temporal.exchange``, differentiable), and the ring's
    wrap reproduces ``torch.roll``'s, so the gathered result equals the
    unsharded shift bit for bit; the boundary patch applies on the first
    (forward) or last (reverse) rank only."""
    import torch.distributed as dist

    from shiftnet_tpu_torch.parallel.temporal import exchange
    c = x.shape[1]
    cs = c // 2
    r = dist.get_rank(group)
    n = dist.get_world_size(group)
    if not reverse:  # y[t] = [x[t-1][c-cs:], x[t][:c-cs]]
        h = x[:, c - cs:]
        recv, = exchange(group, (1,), h[-1:])
        y = torch.cat([torch.cat([recv, h[:-1]]), x[:, :c - cs]], dim=1)
        if boundary_patch and r == 0:
            y = torch.cat([x[:1], y[1:]])
    else:  # y[t] = [x[t][cs:], x[t+1][:cs]]
        h = x[:, :cs]
        recv, = exchange(group, (-1,), h[:1])
        y = torch.cat([x[:, cs:], torch.cat([h[1:], recv])], dim=1)
        if boundary_patch and r == n - 1:
            y = torch.cat([y[:-1], x[-1:]])
    return y


def gsts(x: torch.Tensor, number: int, *, reverse: bool = False,
         boundary_patch: bool = True,
         group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One GSTS round: the temporally shifted y (T, C, H, W) and hw, the
    spatially shifted copy of the moved channels (front 8*number going
    forward, back 8*number in reverse).  The reference concatenates them
    (``gshift_deblur1.py:504-528``); CAB2 takes them apart.  ``group``:
    as in ``temporal_channel_shift`` (the round of the rank's frames,
    then ``ring_edge``)."""
    y = temporal_channel_shift(x, reverse=reverse,
                               boundary_patch=boundary_patch)
    add_c = 8 * number
    hw = y[:, -add_c:] if reverse else y[:, :add_c]
    hw = grouped_spatial_shift(hw, number)
    if group is not None:
        ring_edge(x, y, hw, number, reverse=reverse,
                  boundary_patch=boundary_patch, group=group)
    return y, hw


def ring_edge(x: torch.Tensor, y: torch.Tensor, hw: torch.Tensor,
              number: int, *, reverse: bool, boundary_patch: bool,
              group) -> None:
    """Make (y, hw), a GSTS round of this rank's frames x alone (``gsts``
    or the shift_round kernel), the round of the clip split over the time
    ring ``group``: the one frame whose moving half-channels come from the
    neighbouring rank (frame 0 going forward, frame T-1 in reverse) is
    rewritten in place from the half-channels exchanged over the ring, and
    its hw from that frame's spatial shift.  The rank that holds the
    global boundary frame keeps it where ``boundary_patch`` restored it
    (``shiftnet_tpu/ops/shift.py:158-193``).  Differentiable: the
    rewritten frame's gradient goes back over the ring."""
    import torch.distributed as dist

    from shiftnet_tpu_torch.parallel.temporal import exchange
    c = x.shape[1]
    cs = c // 2
    add_c = 8 * number
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if not reverse:  # y[0] = [x_left[T-1][c-cs:], x[0][:c-cs]]
        recv, = exchange(group, (1,), x[-1:, c - cs:])
        e = torch.cat([recv, x[:1, :c - cs]], dim=1)
        frame, moved, edge_rank = slice(0, 1), slice(0, add_c), 0
    else:  # y[T-1] = [x[T-1][cs:], x_right[0][:cs]]
        recv, = exchange(group, (-1,), x[:1, :cs])
        e = torch.cat([x[-1:, cs:], recv], dim=1)
        frame, moved, edge_rank = slice(-1, None), slice(c - add_c, c), n - 1
    y[frame] = e
    if boundary_patch and r == edge_rank:
        # the global boundary frame keeps its patch; e is written first all
        # the same, so that the exchange, whose backward is a collective,
        # is in every rank's graph
        y[frame] = x[frame]
    else:
        hw[frame] = grouped_spatial_shift(e[:, moved], number)
