"""Differentiable kernel ops: the training path of the fused model.

Counterpart of ``shiftnet_tpu/ops/chw_grad.py``, where each fused op is a
``jax.custom_vjp`` whose forward runs the Pallas kernel and whose backward
is ``jax.vjp`` of the op's XLA twin (``ops/chw_xla.py``), rematerialized
from the saved inputs.  Here each op is a ``torch.autograd.Function``:

- forward: the existing kernel op of ``ops/chw`` / ``ops/naf_chw`` (its
  plain version for CPU tensors), never in place; only the inputs are
  saved;
- backward: the op's plain twin (the ``*_plain`` functions, and
  ``naf_chw.naf_cab_plain`` with the differentiable ``prep_naf``),
  recomputed from the saved inputs under ``enable_grad``, differentiated by
  ``torch.autograd.grad`` back to the raw parameters.

No backward kernel is owed: the JAX package's backward is XLA.  Each op
takes the raw float32 parameters, as the kernel ops do, so the weights'
rounding to the compute type is on the autograd tape of the twin.  The
composites ``tfr_unet`` and ``shift_block_round`` mirror ``chw.tfr_unet``
and one round of ``naf_chw.encoder_shift_block`` with every op routed
through its Function.
"""
from __future__ import annotations

import torch

from shiftnet_tpu_torch.ops import chw, naf_chw
from shiftnet_tpu_torch.ops.shift import ring_edge


def _function(name: str, kernel, plain, doc: str):
    """A ``torch.autograd.Function`` named ``name`` over ``(static,
    *tensors)``: ``kernel(static, *tensors)`` forward, the autograd of
    ``plain(static, *tensors)`` backward.  ``static`` holds what is not a
    tensor (shapes, flags, parameter names)."""

    def forward(ctx, static, *tensors):
        ctx.static = static
        ctx.save_for_backward(*tensors)
        return kernel(static, *tensors)

    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        inputs = [t if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = plain(ctx.static, *inputs)
        outs = out if isinstance(out, tuple) else (out,)
        wrt = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, *(next(got) if n else None for n in need))

    return type(name, (torch.autograd.Function,), {
        '__doc__': doc, 'forward': staticmethod(forward),
        'backward': staticmethod(backward)})


def _params(p: dict[str, torch.Tensor], name: str):
    """The parameters under prefix ``name``: (names without the prefix,
    tensors)."""
    k = chw.prefix(name)
    keys = tuple(key for key in p if key.startswith(k))
    return tuple(key[len(k):] for key in keys), tuple(p[key] for key in keys)


Conv = _function(
    'Conv',
    lambda stride, x, w, b, a: chw.conv(x, w, b, a, stride),
    lambda stride, x, w, b, a: chw.conv_plain(x, w.to(x.dtype), b, a,
                                              stride),
    '``chw.conv`` (``chw_grad.py:31``).')

ConvConcat = _function(
    'ConvConcat',
    lambda n, w, b, a, *xs: chw.conv_concat(list(xs), w, b, a),
    lambda n, w, b, a, *xs: chw.conv_concat_plain(list(xs),
                                                  w.to(xs[0].dtype), b, a),
    '``chw.conv_concat`` (``chw_grad.py:66``).')

Cab = _function(
    'Cab',
    lambda keys, x, *ps: chw.cab(dict(zip(keys, ps)), '', x),
    lambda keys, x, *ps: chw.cab_plain(dict(zip(keys, ps)), '', x),
    'Plain CAB, ``chw.cab`` (``chw_grad.py:117``).')

UpSkip = _function(
    'UpSkip',
    lambda _, x, w11, skip: chw.up_skip(x, w11, skip),
    lambda _, x, w11, skip: chw.up_skip_plain(x, w11.to(x.dtype), skip),
    'SkipUpSample, ``chw.up_skip`` (``chw_grad.py:140``).')

ShiftRound = _function(
    'ShiftRound',
    lambda s, x: naf_chw.shift_round(x, s[0], reverse=s[1],
                                     boundary_patch=s[2]),
    lambda s, x: naf_chw.shift_round_plain(x, s[0], reverse=s[1],
                                           boundary_patch=s[2]),
    'One GSTS round, ``naf_chw.shift_round`` (``chw_grad.py:160``).')

NafCab = _function(
    'NafCab',
    lambda s, y, hw, *ps: naf_chw.naf_cab(dict(zip(s[0], ps)), '', y, hw,
                                          mid_ca=s[1], last_bias=s[2]),
    lambda s, y, hw, *ps: naf_chw.naf_cab_plain(dict(zip(s[0], ps)), '', y,
                                                hw, mid_ca=s[1],
                                                last_bias=s[2]),
    'CAB2 / CAB1, ``naf_chw.naf_cab`` (``chw_grad.py:187``).')


def conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
         alpha: torch.Tensor | None, stride: int = 1) -> torch.Tensor:
    return Conv.apply(stride, x, w, bias, alpha)


def conv_concat(xs: list[torch.Tensor], w: torch.Tensor,
                bias: torch.Tensor | None,
                alpha: torch.Tensor | None) -> torch.Tensor:
    return ConvConcat.apply(len(xs), w, bias, alpha, *xs)


def cab(p: dict[str, torch.Tensor], name: str,
        x: torch.Tensor) -> torch.Tensor:
    keys, ps = _params(p, name)
    return Cab.apply(keys, x, *ps)


def down(p: dict[str, torch.Tensor], name: str, x: torch.Tensor, *,
         with_prelu: bool) -> torch.Tensor:
    k = chw.prefix(name)
    if with_prelu:
        return conv(x, p[f'{k}down.0.weight'], None, p[f'{k}down.1.weight'],
                    stride=2)
    return conv(x, p[f'{k}down.weight'], p[f'{k}down.bias'], None, stride=2)


def up_skip(x: torch.Tensor, w11: torch.Tensor,
            skip: torch.Tensor) -> torch.Tensor:
    return UpSkip.apply(None, x, w11, skip)


def shift_round(x: torch.Tensor, number: int, *, reverse: bool,
                boundary_patch: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return ShiftRound.apply((number, reverse, boundary_patch), x)


def naf_cab(p: dict[str, torch.Tensor], name: str, y: torch.Tensor,
            hw: torch.Tensor | None = None, *, mid_ca: bool = False,
            last_bias: bool = False) -> torch.Tensor:
    keys, ps = _params(p, name)
    return NafCab.apply((keys, mid_ca, last_bias), y, hw, *ps)


def tfr_unet(p: dict[str, torch.Tensor], x: torch.Tensor, *,
             downsample_prelu: bool = False) -> torch.Tensor:
    """``chw.tfr_unet`` with every op through its Function
    (``chw_grad.py:214``); nothing is written in place."""
    dp = dict(with_prelu=downsample_prelu)
    enc1 = cab(p, 'encoder_level1.0', x)
    y = down(p, 'down12', enc1, **dp)
    for i in range(3):
        y = cab(p, f'encoder_level2.{i}', y)
    enc2 = y
    y = down(p, 'down23', enc2, **dp)
    for i in range(3):
        y = cab(p, f'encoder_level3.{i}', y)
    for i in range(3):
        y = cab(p, f'decoder_level3.{i}', y)
    y = up_skip(y, p['up32.up.1.weight'], cab(p, 'skip_attn2', enc2))
    for i in range(3):
        y = cab(p, f'decoder_level2.{i}', y)
    y = up_skip(y, p['up21.up.1.weight'], cab(p, 'skip_attn1', enc1))
    return cab(p, 'decoder_level1.0', y)


def shift_block_round(p: dict[str, torch.Tensor], blk: str, x: torch.Tensor,
                      *, reverse: bool, boundary_patch: bool,
                      mid_ca: bool = False, last_bias: bool = False,
                      group=None) -> torch.Tensor:
    """One round of ``naf_chw.encoder_shift_block``: shift_round -> CAB2
    (``{blk}.0``) -> CAB1 (``{blk}.1``), through the Functions.  On a time
    ring (``group``) ``ops.shift.ring_edge`` then rewrites the frame that
    takes its half-channels from the neighbouring rank (differentiated by
    autograd through the ring exchange)."""
    number = x.shape[1] // 2 // 8
    kw = dict(mid_ca=mid_ca, last_bias=last_bias)
    y, hw = shift_round(x, number, reverse=reverse,
                        boundary_patch=boundary_patch)
    if group is not None:
        ring_edge(x, y, hw, number, reverse=reverse,
                  boundary_patch=boundary_patch, group=group)
    x = naf_cab(p, f'{blk}.0', y, hw, **kw)
    return naf_cab(p, f'{blk}.1', x, **kw)
