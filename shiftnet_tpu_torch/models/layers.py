"""Building blocks of GShiftNet, PyTorch, ``(T, C, H, W)``.

Counterpart of ``shiftnet_tpu/models/layers.py``.  Each module mirrors a
reference block, and attribute names follow the reference's, so
``state_dict`` keys are the reference torch keys (``nn.Sequential`` indices
included) and the output of ``shiftnet_tpu.tools.convert_torch.
flax_to_torch_state`` loads with ``strict=True``.

Parameters are float32; each module computes in its input's type (bf16 at
inference), casting weights on use as flax's ``dtype=`` does.  Parameters are
created zero-filled: ``gshift.init_state`` or a checkpoint fills them, so
building a model touches no global RNG state.

Modules built with ``fused=True`` (the ``fused_chw`` configuration) run on
the CUDA kernels of ``ops/chw`` and ``ops/naf_chw``, or on their plain
versions for CPU tensors; the others are the plain path.  While autograd
records (``torch.is_grad_enabled()``, training), the fused modules go
through the autograd Functions of ``ops/chw_grad`` instead: the same kernels
forward, never in place, and the plain twins' autograd backward.  Without
grad (inference) they run the kernel ops directly, writing in place where a
caller knows its input is dead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from shiftnet_tpu_torch.ops import chw, chw_grad, naf_chw
from shiftnet_tpu_torch.ops.norm import layer_norm_2d
from shiftnet_tpu_torch.ops.resize import bilinear_up2x, pixel_shuffle
from shiftnet_tpu_torch.ops.shift import gsts, temporal_channel_shift


def kernel_ops():
    """The fused modules' op set: ``ops/chw_grad`` while autograd records,
    else ``ops/chw`` (inference)."""
    return chw_grad if torch.is_grad_enabled() else chw


class Conv2d(nn.Module):
    """``nn.Conv2d`` with torch-style padding (default k // 2) that computes
    in the input's type.  Grouped convs stay grouped.  With ``fused`` it
    runs on ``ops.chw.conv``, the bias rounded to the compute type and added
    in float32, as the JAX fused path does."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, *,
                 stride: int = 1, padding: int | None = None,
                 bias: bool = False, groups: int = 1, fused: bool = False):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.groups = groups
        self.fused = fused
        if fused and (groups != 1
                      or self.padding != chw.conv_pad(k, stride)):
            raise ValueError(f'Conv2d: no kernel for k={k} stride={stride} '
                             f'padding={self.padding} groups={groups}')
        self.weight = nn.Parameter(torch.zeros(c_out, c_in // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x):
        if self.fused:
            b = None if self.bias is None else self.bias.to(x.dtype).float()
            return kernel_ops().conv(x, self.weight, b, None, self.stride)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, groups=self.groups)

    def forward_cat(self, xs: list[torch.Tensor],
                    alpha: torch.Tensor | None = None, *,
                    virtual: bool = False) -> torch.Tensor:
        """This conv over ``torch.cat(xs, dim=1)``, then PReLU with slope
        ``alpha`` if given.  With ``fused`` the slope is applied inside the
        launch (one rounding, as the JAX fused path does), and ``virtual``
        (``GShiftNetConfig.conv_concat``, which acts on the fused path only,
        as in JAX) never builds the concat: ``ops.chw.conv_concat`` sums the
        per-input convs."""
        if not self.fused:
            y = self(torch.cat(xs, dim=1))
            return y if alpha is None else chw.prelu(y, alpha)
        dt = xs[0].dtype
        b = None if self.bias is None else self.bias.to(dt).float()
        a = None if alpha is None else alpha.to(dt).float()
        ops = kernel_ops()
        if virtual:
            return ops.conv_concat(xs, self.weight, b, a)
        return ops.conv(torch.cat(xs, dim=1), self.weight, b, a, self.stride)


class PReLU(nn.Module):
    """Single-slope PReLU (``nn.PReLU()``, init 0.25)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return chw.prelu(x, self.weight)


class ConvPReLU(nn.Sequential):
    """``Conv2d`` then ``PReLU`` (Encoder2's ``down01``).  With the conv's
    ``fused`` it is one ``ops.chw.conv`` launch that applies the slope."""

    def __init__(self, conv: Conv2d):
        super().__init__(conv, PReLU())

    def forward(self, x):
        conv, act = self
        if not conv.fused:
            return act(conv(x))
        b = None if conv.bias is None else conv.bias.to(x.dtype).float()
        return kernel_ops().conv(x, conv.weight, b,
                                 act.weight.to(x.dtype).float(), conv.stride)


class LayerNorm2d(nn.Module):
    """Reference ``LayerNorm2d``: channel LayerNorm, eps 1e-6."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


class CALayer(nn.Module):
    """SE-style channel attention (``gshift_deblur1.py:54-70``): mean over
    the valid pixels in float32, cast to the compute type, 1x1 -> ReLU ->
    1x1 -> sigmoid, scale."""

    def __init__(self, channels: int, reduction: int, bias: bool = False):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(channels, channels // reduction, 1, bias=bias), nn.ReLU(),
            Conv2d(channels // reduction, channels, 1, bias=bias),
            nn.Sigmoid())

    def forward(self, x):
        y = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        return x * self.conv_du(y)


class SimpleGate(nn.Module):
    """x1 * x2 over the channel halves."""

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        return x1 * x2


class SimpleGate2(nn.Module):
    """x1 * sigmoid(x2) over the channel halves."""

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        return x1 * torch.sigmoid(x2)


class RepConv(nn.Module):
    """kxk + 3x3 grouped convs + identity (``gshift_deblur1.py:157-165``);
    groups C/8, or depthwise in the small variants."""

    def __init__(self, channels: int, kernel_size: int, *, bias: bool = False,
                 depthwise: bool = False):
        super().__init__()
        g = channels if depthwise else channels // 8
        self.conv_1 = Conv2d(channels, channels, kernel_size, bias=bias,
                             groups=g)
        self.conv_2 = Conv2d(channels, channels, 3, bias=bias, groups=g)

    def forward(self, x):
        return self.conv_1(x) + self.conv_2(x) + x


class RepConv2(nn.Module):
    """Depthwise 3x3 + identity (``gshift_deblur1.py:166-174``)."""

    def __init__(self, channels: int, bias: bool = False):
        super().__init__()
        self.conv_2 = Conv2d(channels, channels, 3, bias=bias, groups=channels)

    def forward(self, x):
        return self.conv_2(x) + x


class CAB(nn.Module):
    """Plain channel-attention block (``gshift_deblur1.py:141-156``):
    conv -> PReLU -> conv -> CALayer, residual.  With ``fused`` it runs on
    ``ops.chw.cab``."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 4,
                 bias: bool = False, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.body = nn.Sequential(
            Conv2d(n_feat, n_feat, kernel_size, bias=bias), PReLU(),
            Conv2d(n_feat, n_feat, kernel_size, bias=bias))
        self.CA = CALayer(n_feat, reduction, bias=bias)

    def forward(self, x, inplace: bool = False):
        """``inplace``: the fused inference path writes the result over x,
        for callers that know x is dead; the plain path and training ignore
        it."""
        if self.fused:
            p = dict(self.named_parameters())
            if torch.is_grad_enabled():
                return chw_grad.cab(p, '', x)
            return chw.cab(p, '', x, inplace=inplace)
        return self.CA(self.body(x)) + x


class ShiftCAB(CAB):
    """``Shift_CAB`` (``gshift_denoise1.py:157-186``): the temporal
    half-channel shift with boundary patch, then a plain CAB, with the
    residual to the *shifted* input.  The shift is plain torch on both paths
    (XLA glue on the JAX fused path too); with ``fused`` the CAB runs on
    ``ops.chw.cab`` and, at inference, writes over the fresh shifted
    tensor.  ``time_group``: the time ring of a clip split over ranks
    (sequence parallelism), whose shift exchanges the edge frame."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 4,
                 *, reverse: bool = False, fused: bool = False,
                 time_group=None):
        super().__init__(n_feat, kernel_size, reduction, fused=fused)
        self.reverse = reverse
        self.time_group = time_group

    def forward(self, x, inplace: bool = False):
        """x is never written; ``inplace`` is accepted for CAB's signature
        and changes nothing."""
        y = temporal_channel_shift(x, reverse=self.reverse,
                                   boundary_patch=True,
                                   group=self.time_group)
        return super().forward(y, inplace=True)


def naf_body(n: int, *, kernel_size: int, reduction: int, c_in: int = 0,
             mid_ca: bool = False, last_bias: bool = False,
             repconv_depthwise: bool = False) -> nn.Sequential:
    """Gated body of CAB1/CAB2 (``gshift_deblur1.py:183-255``): 1x1 expand
    from ``c_in`` (default n) to 2n -> RepConv2 -> SimpleGate -> [CALayer]
    -> RepConv -> 1x1 expand -> SimpleGate2 -> CALayer -> 1x1 project."""
    mods = [Conv2d(c_in or n, 2 * n, 1), RepConv2(2 * n), SimpleGate()]
    if mid_ca:
        mods.append(CALayer(n, reduction))
    mods += [RepConv(n, kernel_size, depthwise=repconv_depthwise),
             Conv2d(n, 2 * n, 1), SimpleGate2(), CALayer(n, reduction),
             Conv2d(n, n, 1, bias=last_bias)]
    return nn.Sequential(*mods)


class CAB1(nn.Module):
    """LN -> gated body, residual scaled by the learned beta
    (``gshift_deblur1.py:183-211``)."""

    def __init__(self, n_feat: int, **body_kw):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(1, n_feat, 1, 1))
        self.norm = LayerNorm2d(n_feat)
        self.body = naf_body(n_feat, **body_kw)

    def forward(self, x):
        return x + self.body(self.norm(x)) * self.beta.to(x.dtype)


class CAB2(nn.Module):
    """CAB1 over the GSTS-augmented input (``gshift_deblur1.py:212-255``):
    the add_c spatially shifted channels ``hw`` go through a depthwise 3x3
    first; LN over the concatenation; residual to the first n channels."""

    def __init__(self, n_feat: int, add_channel: int, **body_kw):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(1, n_feat, 1, 1))
        self.conv1 = Conv2d(add_channel, add_channel, 3, groups=add_channel)
        self.norm = LayerNorm2d(n_feat + add_channel)
        self.body = naf_body(n_feat, c_in=n_feat + add_channel, **body_kw)

    def forward(self, x, hw):
        y = self.norm(torch.cat([x, self.conv1(hw)], dim=1))
        return x + self.body(y) * self.beta.to(x.dtype)


class DownSample(nn.Module):
    """Stride-2 3x3 downsample (``gshift_deblur1.py:330-340``); the denoise
    variants use bias-free + PReLU."""

    def __init__(self, c_in: int, c_out: int, with_prelu: bool = False,
                 fused: bool = False):
        super().__init__()
        self.with_prelu = with_prelu
        self.fused = fused
        if with_prelu:
            self.down = nn.Sequential(Conv2d(c_in, c_out, 3, stride=2),
                                      PReLU())
        else:
            self.down = Conv2d(c_in, c_out, 3, stride=2, bias=True)

    def forward(self, x):
        if self.fused:
            return kernel_ops().down(dict(self.named_parameters()), '', x,
                                     with_prelu=self.with_prelu)
        return self.down(x)


class Upsample2x(nn.Module):
    """Parameter-free bilinear 2x (index 0 of the reference's ``up``)."""

    def forward(self, x):
        return bilinear_up2x(x)


class SkipUpSample(nn.Module):
    """Bilinear 2x + 1x1 conv + skip add (``gshift_deblur1.py:341-351``).
    With ``fused`` it runs on ``ops.chw.up_skip``."""

    def __init__(self, c_in: int, c_out: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.up = nn.Sequential(Upsample2x(), Conv2d(c_in, c_out, 1))

    def forward(self, x, skip):
        if self.fused:
            return kernel_ops().up_skip(x, self.up[1].weight, skip)
        return self.up(x) + skip


class PixelShufflePack(nn.Module):
    """Conv to C*r^2 then depth-to-space (``gshift_deblur1.py:256-278``);
    with ``fused`` the conv runs on ``ops.chw.conv``."""

    def __init__(self, c_in: int, c_out: int, scale: int = 2,
                 upsample_kernel: int = 3, fused: bool = False):
        super().__init__()
        self.scale = scale
        self.upsample_conv = Conv2d(c_in, c_out * scale * scale,
                                    upsample_kernel, bias=True, fused=fused)

    def forward(self, x):
        return pixel_shuffle(self.upsample_conv(x), self.scale)


class TFRUNet(nn.Module):
    """``TFR_UNet`` (``gshift_deblur1.py:681-722``): per-frame 3-level U-Net
    of plain CABs.  With ``fused`` it runs on the CUDA kernels through
    ``ops.chw.tfr_unet`` (the plain versions for CPU tensors)."""

    def __init__(self, n_feat0: int, *, kernel_size: int = 3,
                 reduction: int = 4, scale_unetfeats: int = 12,
                 downsample_prelu: bool = False, fused: bool = False):
        super().__init__()
        c0 = n_feat0
        c1 = c0 + scale_unetfeats
        c2 = c0 + 2 * scale_unetfeats
        self.fused = fused
        self.downsample_prelu = downsample_prelu

        def cabs(c, n):
            return nn.Sequential(*[CAB(c, kernel_size, reduction)
                                   for _ in range(n)])

        self.encoder_level1 = cabs(c0, 1)
        self.down12 = DownSample(c0, c1, downsample_prelu)
        self.encoder_level2 = cabs(c1, 3)
        self.down23 = DownSample(c1, c2, downsample_prelu)
        self.encoder_level3 = cabs(c2, 3)
        self.decoder_level3 = cabs(c2, 3)
        self.skip_attn2 = CAB(c1, kernel_size, reduction)
        self.up32 = SkipUpSample(c2, c1)
        self.decoder_level2 = cabs(c1, 3)
        self.skip_attn1 = CAB(c0, kernel_size, reduction)
        self.up21 = SkipUpSample(c1, c0)
        self.decoder_level1 = cabs(c0, 1)

    def forward(self, x):
        if self.fused:
            return kernel_ops().tfr_unet(
                dict(self.named_parameters()), x,
                downsample_prelu=self.downsample_prelu)
        enc1 = self.encoder_level1(x)
        enc2 = self.encoder_level2(self.down12(enc1))
        dec3 = self.decoder_level3(self.encoder_level3(self.down23(enc2)))
        y = self.decoder_level2(self.up32(dec3, self.skip_attn2(enc2)))
        return self.decoder_level1(self.up21(y, self.skip_attn1(enc1)))


class EncoderShiftBlock(nn.Module):
    """``Encoder_shift_block`` (``gshift_deblur1.py:440-547``): ``rounds``
    iterations of GSTS (forward, then reverse, alternating) -> CAB2 -> CAB1.
    Round r's blocks are ``encoder_level1{_r}.0`` (CAB2) and ``.1`` (CAB1).
    With ``fused`` it runs on ``ops.naf_chw.encoder_shift_block``.

    While autograd records, each (forward, reverse) round pair is a
    ``torch.utils.checkpoint`` (non-reentrant) region, JAX's remat boundary
    (``shiftnet_tpu/models/layers.py:670``); an odd number of rounds runs
    unrolled, as there.

    ``time_group``: the time ring of a clip split over ranks (sequence
    parallelism, JAX's ``time_axis``): each round's temporal shift
    exchanges the edge frame over it (``ops.shift.ring_edge``), and the
    fused form keeps every kernel (``naf_chw.encoder_shift_block``)."""

    def __init__(self, n_feat: int, *, rounds: int = 8, reduction: int = 4,
                 boundary_patch: bool = True, mid_ca: bool = False,
                 last_bias: bool = False, repconv_depthwise: bool = False,
                 fused: bool = False, time_group=None):
        super().__init__()
        self.rounds = rounds
        self.time_group = time_group
        self.boundary_patch = boundary_patch
        self.mid_ca = mid_ca
        self.last_bias = last_bias
        self.fused = fused
        self.number = n_feat // 2 // 8
        add_c = 8 * self.number
        kw = dict(kernel_size=5, reduction=reduction, mid_ca=mid_ca,
                  last_bias=last_bias, repconv_depthwise=repconv_depthwise)
        for r in range(rounds):
            name = 'encoder_level1' if r == 0 else f'encoder_level1_{r}'
            self.add_module(name, nn.Sequential(
                CAB2(n_feat, add_c, **kw), CAB1(n_feat, **kw)))

    def forward(self, x):
        if not torch.is_grad_enabled():
            if self.fused:
                return naf_chw.encoder_shift_block(
                    dict(self.named_parameters()), x, rounds=self.rounds,
                    boundary_patch=self.boundary_patch, mid_ca=self.mid_ca,
                    last_bias=self.last_bias, group=self.time_group)
            return self._rounds(x, 0, self.rounds)
        if self.rounds % 2:
            return self._rounds(x, 0, self.rounds)
        for r in range(0, self.rounds, 2):
            x = checkpoint(self._rounds, x, r, r + 2, use_reentrant=False)
        return x

    def _rounds(self, x, start: int, stop: int):
        """Rounds start .. stop - 1 (fused: through ``ops/chw_grad``)."""
        p = dict(self.named_parameters()) if self.fused else None
        for r in range(start, stop):
            name = 'encoder_level1' if r == 0 else f'encoder_level1_{r}'
            if self.fused:
                x = chw_grad.shift_block_round(
                    p, name, x, reverse=r % 2 == 1,
                    boundary_patch=self.boundary_patch, mid_ca=self.mid_ca,
                    last_bias=self.last_bias, group=self.time_group)
                continue
            y, hw = gsts(x, self.number, reverse=r % 2 == 1,
                         boundary_patch=self.boundary_patch,
                         group=self.time_group)
            cab2, cab1 = self.get_submodule(name)
            x = cab1(cab2(y, hw))
            del y, hw
        return x
