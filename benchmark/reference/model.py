"""The benchmark's frozen plain GShiftNet: float32 PyTorch, no kernels.

A copy of the plain path of the program's model (GShiftNet, Shift-Net,
CVPR 2023; reference ``gshift_deblur1.py`` / ``gshift_deblur2.py`` /
``gshift_denoise1.py``), kept here so that the comparison that decides
``correct`` does not depend on the program: it imports nothing of it.
Parameters are keyed as the program's ``state_dict`` (the reference torch
keys), so the weights the benchmark makes load into both.  Everything the
program derives from the raw weights (the merged RepConv, the LayerNorm
folded into the expand, the packed panels) is worked out here from the raw
weights again, by computing the unmerged blocks.

Two things the program has no use for:

- ``block``: at inference, every per-frame stage runs on blocks of that
  many frames (convs treat frames as a batch, and channel attention pools
  each frame whole, so this is exact); the temporal shifts see the whole
  clip.  That keeps a 52-frame 720p window in float32 inside one card.
- ``quant``: a rounding applied to the input and the weight of every conv,
  the control's lower precision (``precision.py``); identity by default.

While autograd records, each TFR U-Net and each shift-block round pair is a
``torch.utils.checkpoint`` region when ``remat`` is set, so a float32
training step at the training cell's size fits.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# The model keys of a configuration file, with the preset they start from
# (``deblur_plus``, the big deblurring variant).
ARCH_DEFAULTS = dict(
    in_channels=3, n_feats0=24, n_feats2=80, num_orbs=5, tfr_scale=12,
    shift_rounds=8, encoder2_levels=3, encoder2_shift_encoder=False,
    encoder2_level0_shift_cabs=False, encoder2_level1_shift_cabs=False,
    final_fuse_concat=True, boundary_patch=True, cab_mid_ca=False,
    cab_last_bias=False, ca_reduction=4, repconv_depthwise=False,
    downsample_prelu=False, stage_residual=True,
    stage2_uses_conv_trans=False, rconcat_bias=True, rconcat_act=False,
    conv_last_ks=5, past_frames=1, future_frames=1)


@dataclasses.dataclass(frozen=True)
class Arch:
    in_channels: int
    n_feats0: int
    n_feats2: int
    num_orbs: int
    tfr_scale: int
    shift_rounds: int
    encoder2_levels: int
    encoder2_shift_encoder: bool
    encoder2_level0_shift_cabs: bool
    encoder2_level1_shift_cabs: bool
    final_fuse_concat: bool
    boundary_patch: bool
    cab_mid_ca: bool
    cab_last_bias: bool
    ca_reduction: int
    repconv_depthwise: bool
    downsample_prelu: bool
    stage_residual: bool
    stage2_uses_conv_trans: bool
    rconcat_bias: bool
    rconcat_act: bool
    conv_last_ks: int
    past_frames: int
    future_frames: int

    @classmethod
    def from_config(cls, model: dict, **overrides) -> 'Arch':
        """From a configuration file's ``model`` keys (any key left out
        takes ``ARCH_DEFAULTS``'), then ``overrides``."""
        unknown = set(model) - set(ARCH_DEFAULTS)
        if unknown:
            raise ValueError(f'unknown model keys {sorted(unknown)}')
        return cls(**{**ARCH_DEFAULTS, **model, **overrides})

    @property
    def noise_map(self) -> bool:
        return self.in_channels == 4


# -- ops ----------------------------------------------------------------------

SHIFT_DIRS_OUTER = (
    (8, 8), (8, 4), (8, 0), (8, -4), (8, -8),
    (-8, 8), (-8, 4), (-8, 0), (-8, -4), (-8, -8),
    (4, 8), (4, -8), (0, 8), (0, -8), (-4, 8), (-4, -8),
)
SHIFT_DIRS_INNER = (
    (4, 4), (4, 0), (4, -4), (0, 4), (0, -4), (-4, 4), (-4, 0), (-4, -4),
)


def grouped_spatial_shift(hw, number):
    """24 channel groups of hw (T, 8*number, H, W), each translated by its
    (dy, dx), out[y, x] = in[y - dy, x - dx], zero fill."""
    n2 = (number - 1) // 2
    n1 = number - 2 * n2
    h, w = hw.shape[2:]
    s = 8
    padded = F.pad(hw, (s, s, s, s))
    parts, c = [], 0
    for size, dirs in ((n2, SHIFT_DIRS_OUTER), (n1, SHIFT_DIRS_INNER)):
        for dy, dx in dirs:
            if size:
                parts.append(padded[:, c:c + size, s - dy:s - dy + h,
                                    s - dx:s - dx + w])
            c += size
    return torch.cat(parts, dim=1)


def temporal_shift(x, reverse, boundary_patch):
    """Half the channels one frame forward (back in reverse), the channel
    order rotated within each frame; the wrapped frame restored to its
    input with ``boundary_patch``."""
    c = x.shape[1]
    cs = c // 2
    if not reverse:
        y = torch.cat([torch.roll(x[:, c - cs:], 1, dims=0), x[:, :c - cs]],
                      dim=1)
        if boundary_patch:
            y = torch.cat([x[:1], y[1:]])
    else:
        y = torch.cat([x[:, cs:], torch.roll(x[:, :cs], -1, dims=0)], dim=1)
        if boundary_patch:
            y = torch.cat([y[:-1], x[-1:]])
    return y


def layer_norm_2d(x, weight, bias, eps=1e-6):
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    var = xc.square().mean(dim=1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return y * weight[:, None, None] + bias[:, None, None]


# -- modules ------------------------------------------------------------------

class Conv2d(nn.Module):
    def __init__(self, c_in, c_out, k, *, stride=1, padding=None, bias=False,
                 groups=1):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(c_out, c_in // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.quant = None

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv2d(x, w, self.bias, self.stride, self.padding,
                        groups=self.groups)


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return F.prelu(x, self.weight)


class CALayer(nn.Module):
    def __init__(self, c, reduction, bias=False):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(c, c // reduction, 1, bias=bias), nn.ReLU(),
            Conv2d(c // reduction, c, 1, bias=bias), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class SimpleGate(nn.Module):
    def forward(self, x):
        a, b = x.chunk(2, dim=1)
        return a * b


class SimpleGate2(nn.Module):
    def forward(self, x):
        a, b = x.chunk(2, dim=1)
        return a * torch.sigmoid(b)


class RepConv(nn.Module):
    def __init__(self, c, k, depthwise=False):
        super().__init__()
        g = c if depthwise else c // 8
        self.conv_1 = Conv2d(c, c, k, groups=g)
        self.conv_2 = Conv2d(c, c, 3, groups=g)

    def forward(self, x):
        return self.conv_1(x) + self.conv_2(x) + x


class RepConv2(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_2 = Conv2d(c, c, 3, groups=c)

    def forward(self, x):
        return self.conv_2(x) + x


class CAB(nn.Module):
    def __init__(self, c, reduction):
        super().__init__()
        self.body = nn.Sequential(Conv2d(c, c, 3), PReLU(), Conv2d(c, c, 3))
        self.CA = CALayer(c, reduction)

    def forward(self, x):
        return self.CA(self.body(x)) + x


class ShiftCAB(CAB):
    """The temporal half-channel shift (boundary patched), then a CAB with
    the residual to the shifted input."""

    def __init__(self, c, reduction, reverse):
        super().__init__(c, reduction)
        self.reverse = reverse


def naf_body(n, *, reduction, c_in=0, mid_ca=False, last_bias=False,
             depthwise=False):
    mods = [Conv2d(c_in or n, 2 * n, 1), RepConv2(2 * n), SimpleGate()]
    if mid_ca:
        mods.append(CALayer(n, reduction))
    mods += [RepConv(n, 5, depthwise), Conv2d(n, 2 * n, 1), SimpleGate2(),
             CALayer(n, reduction), Conv2d(n, n, 1, bias=last_bias)]
    return nn.Sequential(*mods)


class LayerNorm2d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return layer_norm_2d(x, self.weight, self.bias)


class CAB1(nn.Module):
    def __init__(self, n, **kw):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(1, n, 1, 1))
        self.norm = LayerNorm2d(n)
        self.body = naf_body(n, **kw)

    def forward(self, x):
        return x + self.body(self.norm(x)) * self.beta


class CAB2(nn.Module):
    def __init__(self, n, add_c, **kw):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(1, n, 1, 1))
        self.conv1 = Conv2d(add_c, add_c, 3, groups=add_c)
        self.norm = LayerNorm2d(n + add_c)
        self.body = naf_body(n, c_in=n + add_c, **kw)

    def forward(self, x, hw):
        y = self.norm(torch.cat([x, self.conv1(hw)], dim=1))
        return x + self.body(y) * self.beta


class DownSample(nn.Module):
    def __init__(self, c_in, c_out, with_prelu):
        super().__init__()
        if with_prelu:
            self.down = nn.Sequential(Conv2d(c_in, c_out, 3, stride=2),
                                      PReLU())
        else:
            self.down = Conv2d(c_in, c_out, 3, stride=2, bias=True)

    def forward(self, x):
        return self.down(x)


class Upsample2x(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode='bilinear',
                             align_corners=False)


class SkipUpSample(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.up = nn.Sequential(Upsample2x(), Conv2d(c_in, c_out, 1))

    def forward(self, x, skip):
        return self.up(x) + skip


class PixelShufflePack(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.upsample_conv = Conv2d(c_in, c_out * 4, 3, bias=True)

    def forward(self, x):
        return F.pixel_shuffle(self.upsample_conv(x), 2)


class TFRUNet(nn.Module):
    def __init__(self, c0, *, reduction, scale, prelu):
        super().__init__()
        c1, c2 = c0 + scale, c0 + 2 * scale

        def cabs(c, n):
            return nn.Sequential(*[CAB(c, reduction) for _ in range(n)])
        self.encoder_level1 = cabs(c0, 1)
        self.down12 = DownSample(c0, c1, prelu)
        self.encoder_level2 = cabs(c1, 3)
        self.down23 = DownSample(c1, c2, prelu)
        self.encoder_level3 = cabs(c2, 3)
        self.decoder_level3 = cabs(c2, 3)
        self.skip_attn2 = CAB(c1, reduction)
        self.up32 = SkipUpSample(c2, c1)
        self.decoder_level2 = cabs(c1, 3)
        self.skip_attn1 = CAB(c0, reduction)
        self.up21 = SkipUpSample(c1, c0)
        self.decoder_level1 = cabs(c0, 1)

    def forward(self, x):
        enc1 = self.encoder_level1(x)
        enc2 = self.encoder_level2(self.down12(enc1))
        dec3 = self.decoder_level3(self.encoder_level3(self.down23(enc2)))
        y = self.decoder_level2(self.up32(dec3, self.skip_attn2(enc2)))
        return self.decoder_level1(self.up21(y, self.skip_attn1(enc1)))


class EncoderShiftBlock(nn.Module):
    """``rounds`` x [GSTS (forward, reverse alternating) -> CAB2 -> CAB1]."""

    def __init__(self, n, *, rounds, reduction, boundary_patch, mid_ca,
                 last_bias, depthwise):
        super().__init__()
        self.rounds = rounds
        self.boundary_patch = boundary_patch
        self.number = n // 2 // 8
        kw = dict(reduction=reduction, mid_ca=mid_ca, last_bias=last_bias,
                  depthwise=depthwise)
        for r in range(rounds):
            name = 'encoder_level1' if r == 0 else f'encoder_level1_{r}'
            self.add_module(name, nn.Sequential(
                CAB2(n, 8 * self.number, **kw), CAB1(n, **kw)))


class Frames:
    """Runs per-frame functions on blocks of frames (see the module doc)
    and the remat regions of training."""

    def __init__(self, block: int | None = None, remat: bool = False):
        self.block = block
        self.remat = remat

    def __call__(self, fn, *xs):
        t = xs[0].shape[0]
        if self.block is None or t <= self.block or torch.is_grad_enabled():
            return fn(*xs)
        out = None
        for s in range(0, t, self.block):
            y = fn(*(x[s:s + self.block] for x in xs))
            if out is None:
                out = y.new_empty((t, *y.shape[1:]))
            out[s:s + self.block] = y
            del y
        return out

    def region(self, fn, *xs):
        """fn(*xs), a checkpoint region while autograd records with
        ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *xs, use_reentrant=False)
        return fn(*xs)


def shift_block(blk: EncoderShiftBlock, x, frames: Frames):
    def rounds(x, start, stop):
        for r in range(start, stop):
            name = 'encoder_level1' if r == 0 else f'encoder_level1_{r}'
            cab2, cab1 = blk.get_submodule(name)
            reverse = r % 2 == 1
            y = temporal_shift(x, reverse, blk.boundary_patch)
            add_c = 8 * blk.number
            hw = grouped_spatial_shift(y[:, -add_c:] if reverse
                                       else y[:, :add_c], blk.number)
            x = frames(lambda a, b: cab1(cab2(a, b)), y, hw)
            del y, hw
        return x
    if blk.rounds % 2 or not torch.is_grad_enabled():
        return rounds(x, 0, blk.rounds)
    for r in range(0, blk.rounds, 2):
        x = frames.region(rounds, x, r, r + 2)
    return x


def shift_cab(cab: ShiftCAB, x, frames: Frames):
    y = temporal_shift(x, cab.reverse, True)
    return frames(cab, y)


class Encoder2(nn.Module):
    def __init__(self, a: Arch):
        super().__init__()
        nf, nf0, red = a.n_feats2, a.n_feats0, a.ca_reduction
        self.a = a
        skw = dict(rounds=a.shift_rounds, reduction=red,
                   boundary_patch=a.boundary_patch, mid_ca=a.cab_mid_ca,
                   last_bias=a.cab_last_bias, depthwise=a.repconv_depthwise)
        dp = a.downsample_prelu

        def blocks(*names):
            for name in names:
                self.add_module(name, EncoderShiftBlock(nf, **skw))
        self.concat = CAB(nf0, red)
        if a.encoder2_level0_shift_cabs:
            self.encoder_level0 = ShiftCAB(nf0, red, False)
            self.encoder_level0_1 = ShiftCAB(nf0, red, True)
        self.down01 = nn.Sequential(Conv2d(nf0, nf, 2, stride=2, padding=0),
                                    PReLU())
        if a.encoder2_shift_encoder:
            blocks('encoder_level1', 'encoder_level1_1', 'encoder_level1_2')
        elif a.encoder2_level1_shift_cabs:
            self.encoder_level1 = ShiftCAB(nf, red, False)
            self.encoder_level1_1 = ShiftCAB(nf, red, True)
        else:
            self.encoder_level1 = CAB(nf, red)
            self.encoder_level1_1 = CAB(nf, red)
        self.down12 = DownSample(nf, nf, dp)
        if a.encoder2_shift_encoder:
            blocks('encoder_level2', 'encoder_level2_1', 'encoder_level2_2',
                   'decoder_level2', 'decoder_level2_1', 'decoder_level2_2')
        else:
            self.encoder_level2 = CAB(nf, red)
            self.encoder_level2_1 = CAB(nf, red)
            self.down23 = DownSample(nf, nf, dp)
            self.encoder_level3 = CAB(nf, red)
            self.encoder_level3_1 = CAB(nf, red)
            blocks('decoder_level3', 'decoder_level3_1')
            self.skip_attn2 = CAB(nf, red)
            self.up32 = SkipUpSample(nf, nf)
            blocks('decoder_level2', 'decoder_level2_1')
        self.skip_attn1 = CAB(nf, red)
        self.up21 = SkipUpSample(nf, nf)
        blocks('decoder_level1', 'decoder_level1_1', 'decoder_level1_2')
        self.upsample0 = PixelShufflePack(nf, nf0)
        self.skip_conv = CAB(nf0, red)
        if a.final_fuse_concat:
            self.conv_hr0 = Conv2d(2 * nf0, nf0, 3, bias=True)
        else:
            self.act = PReLU()
            self.conv_hr0 = Conv2d(nf0, nf0, 3)
        self.out_conv = CAB(nf0, red)

    def _level(self, x, names, frames):
        for name in names:
            m = self.get_submodule(name)
            if isinstance(m, EncoderShiftBlock):
                x = shift_block(m, x, frames)
            elif isinstance(m, ShiftCAB):
                x = shift_cab(m, x, frames)
            else:
                x = frames(m, x)
        return x

    def forward(self, x, frames: Frames):
        a = self.a
        x = frames(self.concat, x)
        skip = frames(self.skip_conv, x)
        if a.encoder2_level0_shift_cabs:
            x = self._level(x, ('encoder_level0', 'encoder_level0_1'), frames)
        x = frames(self.down01, x)
        enc11 = self._level(x, ('encoder_level1', 'encoder_level1_1') + (
            ('encoder_level1_2',) if a.encoder2_shift_encoder else ()),
            frames)
        del x
        if a.encoder2_shift_encoder:
            y = self._level(frames(self.down12, enc11), (
                'encoder_level2', 'encoder_level2_1', 'encoder_level2_2',
                'decoder_level2', 'decoder_level2_1', 'decoder_level2_2'),
                frames)
        else:
            enc22 = self._level(frames(self.down12, enc11),
                                ('encoder_level2', 'encoder_level2_1'), frames)
            y = self._level(frames(self.down23, enc22),
                            ('encoder_level3', 'encoder_level3_1',
                             'decoder_level3', 'decoder_level3_1'), frames)
            y = frames(lambda a_, b_: self.up32(a_, self.skip_attn2(b_)),
                       y, enc22)
            del enc22
            y = self._level(y, ('decoder_level2', 'decoder_level2_1'), frames)
        y = frames(lambda a_, b_: self.up21(a_, self.skip_attn1(b_)), y, enc11)
        del enc11
        y = self._level(y, ('decoder_level1', 'decoder_level1_1',
                            'decoder_level1_2'), frames)

        def tail(y_, skip_):
            up = self.upsample0(y_)
            if a.final_fuse_concat:
                out = self.conv_hr0(torch.cat([up, skip_], dim=1))
            else:
                out = self.conv_hr0(self.act(up)) + skip_
            return self.out_conv(out)
        return frames(tail, y, skip)


class GShiftNet(nn.Module):
    """Stage 0 (TFR U-Nets per frame), Encoder2, stage 2 (TFR U-Nets on the
    center frames); input (T, C_in, H, W), output (T - past - future, 3, H,
    W) with the global residual."""

    def __init__(self, a: Arch):
        super().__init__()
        self.a = a
        nf0 = a.n_feats0
        tkw = dict(reduction=a.ca_reduction, scale=a.tfr_scale,
                   prelu=a.downsample_prelu)
        self.feat_extract = nn.Sequential(
            Conv2d(a.in_channels, nf0, 3, bias=True), CAB(nf0, a.ca_reduction))
        for i in range(a.num_orbs):
            self.add_module(f'orb{i + 1}', TFRUNet(nf0, **tkw))
        self.conv_trans = Conv2d(nf0, nf0, 3, bias=True)
        self.stage1 = Encoder2(a)
        self.rconcat = Conv2d(3 * nf0, nf0, 3, bias=a.rconcat_bias)
        if a.rconcat_act:
            self.lrelu = PReLU()
        for i in range(a.num_orbs):
            self.add_module(f'rorb{i + 1}', TFRUNet(nf0, **tkw))
        self.conv_last = Conv2d(nf0, 3, a.conv_last_ks)

    def _orbs(self, prefix, y, frames):
        for i in range(self.a.num_orbs):
            y = frames.region(frames, self.get_submodule(f'{prefix}{i + 1}'),
                              y)
        return y

    def forward(self, x, noise_map=None, frames: Frames | None = None):
        a = self.a
        frames = frames or Frames()
        t = x.shape[0]
        center = slice(a.past_frames, t - a.future_frames)
        if a.noise_map:
            x0 = frames(self.feat_extract, torch.cat([x, noise_map], dim=1))
        else:
            x0 = frames(self.feat_extract, x)
        y = self._orbs('orb', x0, frames)
        feats = y + x0 if a.stage_residual else y
        del y
        if a.stage2_uses_conv_trans:
            feats = frames(self.conv_trans, feats)
            dec = self.stage1(feats, frames)
        else:
            dec = self.stage1(frames(self.conv_trans, feats), frames)

        def fuse(*parts):
            z = self.rconcat(torch.cat(parts, dim=1))
            return self.lrelu(z) if a.rconcat_act else z
        z = frames(fuse, x0[center], feats[center], dec[center])
        del x0, feats, dec
        y = self._orbs('rorb', z, frames)
        if a.stage_residual:
            y = y + z
        del z
        return frames(self.conv_last, y) + x[center]


def set_quant(model: nn.Module, quant) -> None:
    """Give every conv of ``model`` the rounding ``quant`` (None: none)."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.quant = quant
