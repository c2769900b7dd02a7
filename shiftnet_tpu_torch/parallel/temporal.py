"""Temporal (sequence) parallelism: the frame axis split over ranks.

Counterpart of ``shiftnet_tpu/parallel/temporal.py`` and of the
``ppermute`` exchanges of ``shiftnet_tpu/ops/shift.py:158-193``.

- ``exchange``: each rank of a time ring sends tensors to the ranks a
  given number of places on along the ring (mod its size) and receives
  theirs.  One autograd Function: the backward sends each received
  tensor's gradient back to the rank it came from.  It is one
  ``all_gather`` of the tensors' bytes over the ring, a collective that
  both NCCL and gloo take with CUDA tensors, so both backends run the same
  code.
- ``temporal_parallel_forward``: windowed inference with the window's
  frames split over the ring.  Each rank receives ``halo`` frames from each
  neighbour and runs the local forward on ``local + 2 * halo`` frames.  At
  the ring's ends the JAX code's rule holds (``temporal.py:64-65``): rank
  0's left halo is its own first ``halo`` frames, ``x[:halo]``, and the last
  rank's right halo its own last ``halo`` frames, ``x[-halo:]``.  (The
  JAX module docstring describes a clamp, ``[x0, x0]`` for ``halo = 2``;
  its code, and this module, give ``[x0, x1]``.)
- ``shard_bounds``: the frame ranges of an uneven split, ``ceil(T / n)``
  frames on the first ``T % n`` ranks and ``floor(T / n)`` on the rest, so
  no frame is repeated to pad a window.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _gather_bytes(group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's ``tensors`` as one flat uint8 buffer per rank (the
    tensors' shapes and types must agree across the ring)."""
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return parts


def _exchange(group, shifts, tensors):
    """Tensor i goes to the rank ``shifts[i]`` places on; returns, for
    each i, the tensor received from the rank ``shifts[i]`` places back."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    parts = _gather_bytes(group, tensors)
    out, off = [], 0
    for s, t in zip(shifts, tensors):
        k = t.numel() * t.element_size()
        src = parts[(r - s) % n][off:off + k]
        out.append(src.view(t.dtype).view(t.shape))
        off += k
    return out


class Exchange(torch.autograd.Function):
    """``exchange`` with its backward: the gradient of each received tensor
    goes back to its sender (``ppermute``'s transpose in JAX)."""

    @staticmethod
    def forward(ctx, group, shifts, *tensors):
        ctx.group, ctx.shifts = group, shifts
        return tuple(_exchange(group, shifts, list(tensors)))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        back = _exchange(ctx.group, [-s for s in ctx.shifts], grads)
        return (None, None, *back)


def exchange(group, shifts: tuple[int, ...],
             *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Send ``tensors[i]`` to the ring rank ``shifts[i]`` places on and
    return what arrives from ``shifts[i]`` places back (``shifts`` +1:
    from the left neighbour; -1: from the right one).  Differentiable."""
    return Exchange.apply(group, tuple(shifts), *tensors)


def exchange_halos(x: torch.Tensor, group, halo: int) -> torch.Tensor:
    """``(L, ...)`` -> ``(L + 2 * halo, ...)``: the left neighbour's last
    ``halo`` frames, x, the right neighbour's first ``halo``; at the ring's
    ends the rank's own edge frames (``temporal.py:64-65``)."""
    if x.shape[0] < halo:
        raise ValueError(f'a shard of {x.shape[0]} frames cannot send a '
                         f'halo of {halo}')
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    from_left, from_right = exchange(group, (1, -1), x[-halo:], x[:halo])
    if r == 0:
        from_left = x[:halo]
    if r == n - 1:
        from_right = x[-halo:]
    return torch.cat([from_left, x, from_right], dim=0)


def temporal_parallel_forward(apply_fn: Callable, group,
                              halo: int = 2) -> Callable:
    """Wrap a per-clip forward ``apply_fn(clip[, noise_map])`` into one
    over this rank's frames of a window split along its frame axis.

    The wrapped function takes the rank's ``(L, C, H, W)`` frames (and
    noise map) and returns its ``L`` restored frames; the model must
    predict all but ``halo`` frames on each side (``past_frames =
    future_frames = halo``).  Interior shard boundaries see exactly
    ``halo`` frames of context, the reference's windowed inference with a
    window of the shard's frames."""

    def sharded(x: torch.Tensor, noise_map: torch.Tensor | None = None):
        xs = exchange_halos(x, group, halo)
        if noise_map is None:
            return apply_fn(xs)
        return apply_fn(xs, exchange_halos(noise_map, group, halo))

    return sharded


def shard_bounds(t: int, n: int) -> list[tuple[int, int]]:
    """[(start, stop)] of ``t`` frames over ``n`` ranks: ``ceil(t / n)``
    frames on the first ``t % n`` ranks, ``floor(t / n)`` on the rest."""
    base, extra = divmod(t, n)
    bounds, s = [], 0
    for r in range(n):
        e = s + base + (1 if r < extra else 0)
        bounds.append((s, e))
        s = e
    return bounds


def gather_frames(x: torch.Tensor, group,
                  bounds: list[tuple[int, int]]) -> torch.Tensor:
    """The ranks' frames ``(L_r, ...)`` (``bounds`` from
    ``shard_bounds``) joined in rank order on every rank.  Shorter shards
    travel padded to the longest (transport only; the padding is cut)."""
    longest = max(e - s for s, e in bounds)
    pad = longest - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    parts = _gather_bytes(group, [x])
    return torch.cat([p.view(x.dtype).view(x.shape)[:e - s]
                      for p, (s, e) in zip(parts, bounds)])
