"""GShiftNet, the grouped spatial-temporal shift video restoration network.

Counterpart of ``shiftnet_tpu/models/gshift.py`` (``Encoder2``,
``GShiftNet``, ``build_model``).  Input is one clip ``(T, C_in, H, W)``; the
forward predicts the ``T - past - future`` center frames with a global
residual to the input (reference ``gshift_deblur1.py:783-791``).

With ``cfg.fused_chw`` every module of the forward that the JAX package's
``_forward_chw`` (``gshift.py:407-500``) runs on a Pallas kernel runs on a
CUDA kernel here (``ops/chw``, ``ops/naf_chw``), or on its plain version for
CPU tensors; the concats, residual adds, the pixel shuffle and the add-fuse
PReLU stay plain torch, as they are XLA ops there.

All four variants run: deblur_plus; denoise_plus with its noise-map input
and Encoder2's ShiftCABs at levels 0 and 1; and the small variants
(deblur_small, denoise_small) with their shift-block encoder over two
levels (``encoder2_shift_encoder``), the depthwise RepConv, and in
deblur_small add-fuse (``final_fuse_concat=False``) and no boundary patch.
With ``cfg.conv_concat`` (fused path only, as in JAX) rconcat, and conv_hr0
where it reads a concat, run as one ``conv_cat`` launch each over their
unconcatenated inputs.

While autograd records (training), each TFR U-Net of the orb chains is a
``torch.utils.checkpoint`` (non-reentrant) region, JAX's remat boundary
(``shiftnet_tpu/models/gshift.py:397``), as is each shift-block round pair
(``layers.EncoderShiftBlock``), and the fused modules run through
``ops/chw_grad``.  Inference is unchanged.

With ``cfg.time_group`` (sequence parallelism, the counterpart of JAX's
``time_axis``) the model runs on one rank's frames of a clip split over a
time ring: every ShiftCAB and shift-block round exchanges its edge frame
with the neighbouring ranks (``ops/shift.py``); everything else is per
frame.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from shiftnet_tpu_torch.models.config import CONFIGS, GShiftNetConfig
from shiftnet_tpu_torch.models.layers import (CAB, Conv2d, ConvPReLU,
                                              DownSample, EncoderShiftBlock,
                                              PReLU, PixelShufflePack,
                                              ShiftCAB, SkipUpSample, TFRUNet)


class Encoder2(nn.Module):
    """Temporal-fusion U-Net (``gshift_deblur1.py:548-642``, small variant
    ``gshift_deblur2.py:531-614``, denoise ``gshift_denoise1.py:573-670``).

    Big variants: plain-CAB encoder over 3 levels (ShiftCABs at levels 0
    and 1 in denoise_plus), shift blocks in the decoder.  Small variants
    (``encoder2_shift_encoder``): 2 levels, 3 shift blocks at each level of
    the encoder and the decoder; deblur_small fuses the full-res shortcut
    by PReLU -> bias-free conv_hr0 -> add (``final_fuse_concat=False``)
    instead of a conv over the concat.

    On the fused inference path the CABs of the level chains write over
    their input, which is dead there: each chain starts on the fresh output of a conv.
    ``concat``'s output is read by both ``skip_conv`` and the next stage,
    and enc11 / enc22 by ``skip_attn1`` / ``skip_attn2`` and the next down
    conv, so the CABs that read those write fresh outputs.  A ShiftCAB or
    a shift block never writes its input."""

    def __init__(self, cfg: GShiftNetConfig):
        super().__init__()
        nf, nf0, red = cfg.n_feats2, cfg.n_feats0, cfg.ca_reduction
        fused = cfg.fused_chw
        self.conv_concat = cfg.conv_concat
        self.shift_encoder = cfg.encoder2_shift_encoder
        self.fuse_concat = cfg.final_fuse_concat
        ring = cfg.time_group
        shift_kw = dict(rounds=cfg.shift_rounds, reduction=red,
                        boundary_patch=cfg.boundary_patch,
                        mid_ca=cfg.cab_mid_ca, last_bias=cfg.cab_last_bias,
                        repconv_depthwise=cfg.repconv_depthwise, fused=fused,
                        time_group=ring)
        dp = cfg.downsample_prelu

        def cab(c):
            return CAB(c, 3, red, fused=fused)

        def shift_cab(c, reverse):
            return ShiftCAB(c, 3, red, reverse=reverse, fused=fused,
                            time_group=ring)

        def shift_blocks(*names):
            for name in names:
                self.add_module(name, EncoderShiftBlock(nf, **shift_kw))

        self.concat = cab(nf0)
        self.level0_shift_cabs = cfg.encoder2_level0_shift_cabs
        if self.level0_shift_cabs:
            self.encoder_level0 = shift_cab(nf0, False)
            self.encoder_level0_1 = shift_cab(nf0, True)
        self.down01 = ConvPReLU(
            Conv2d(nf0, nf, 2, stride=2, padding=0, fused=fused))
        if self.shift_encoder:
            shift_blocks('encoder_level1', 'encoder_level1_1',
                         'encoder_level1_2')
        elif cfg.encoder2_level1_shift_cabs:
            self.encoder_level1 = shift_cab(nf, False)
            self.encoder_level1_1 = shift_cab(nf, True)
        else:
            self.encoder_level1 = cab(nf)
            self.encoder_level1_1 = cab(nf)
        self.down12 = DownSample(nf, nf, dp, fused=fused)
        if self.shift_encoder:
            shift_blocks('encoder_level2', 'encoder_level2_1',
                         'encoder_level2_2', 'decoder_level2',
                         'decoder_level2_1', 'decoder_level2_2')
        else:
            self.encoder_level2 = cab(nf)
            self.encoder_level2_1 = cab(nf)
            self.down23 = DownSample(nf, nf, dp, fused=fused)
            self.encoder_level3 = cab(nf)
            self.encoder_level3_1 = cab(nf)
            shift_blocks('decoder_level3', 'decoder_level3_1')
            self.skip_attn2 = cab(nf)
            self.up32 = SkipUpSample(nf, nf, fused=fused)
            shift_blocks('decoder_level2', 'decoder_level2_1')
        self.skip_attn1 = cab(nf)
        self.up21 = SkipUpSample(nf, nf, fused=fused)
        shift_blocks('decoder_level1', 'decoder_level1_1', 'decoder_level1_2')
        self.upsample0 = PixelShufflePack(nf, nf0, scale=2, upsample_kernel=3,
                                          fused=fused)
        self.skip_conv = cab(nf0)
        if self.fuse_concat:
            self.conv_hr0 = Conv2d(2 * nf0, nf0, 3, bias=True, fused=fused)
        else:
            self.act = PReLU()
            self.conv_hr0 = Conv2d(nf0, nf0, 3, fused=fused)
        self.out_conv = cab(nf0)

    def _chain(self, x, *names, inplace=False):
        """The named blocks in turn; ``inplace`` passes on to CABs."""
        for name in names:
            blk = getattr(self, name)
            x = blk(x, inplace=True) if inplace else blk(x)
        return x

    def forward(self, x):
        x = self.concat(x)
        skip = self.skip_conv(x)  # the full-res shortcut is only read here
        if self.level0_shift_cabs:
            x = self.encoder_level0_1(self.encoder_level0(x))
        x = self.down01(x)
        if self.shift_encoder:
            enc11 = self._chain(x, 'encoder_level1', 'encoder_level1_1',
                                'encoder_level1_2')
            del x
            y = self._chain(self.down12(enc11), 'encoder_level2',
                            'encoder_level2_1', 'encoder_level2_2',
                            'decoder_level2', 'decoder_level2_1',
                            'decoder_level2_2')
        else:
            enc11 = self._chain(x, 'encoder_level1', 'encoder_level1_1',
                                inplace=True)
            del x
            enc22 = self._chain(self.down12(enc11), 'encoder_level2',
                                'encoder_level2_1', inplace=True)
            y = self._chain(self.down23(enc22), 'encoder_level3',
                            'encoder_level3_1', inplace=True)
            y = self._chain(y, 'decoder_level3', 'decoder_level3_1')
            y = self.up32(y, self.skip_attn2(enc22))
            del enc22
            y = self._chain(y, 'decoder_level2', 'decoder_level2_1')
        y = self.up21(y, self.skip_attn1(enc11))
        del enc11
        y = self._chain(y, 'decoder_level1', 'decoder_level1_1',
                        'decoder_level1_2')
        up = self.upsample0(y)
        del y
        if self.fuse_concat:
            out = self.conv_hr0.forward_cat([up, skip],
                                            virtual=self.conv_concat)
        else:  # PReLU and the add in the compute type, as in JAX
            out = self.conv_hr0(self.act(up))
            out += skip
        del up, skip
        return self.out_conv(out, inplace=True)


class GShiftNet(nn.Module):
    """Three-stage network (``gshift_deblur1.py:726-791``): TFR U-Nets per
    frame (stage 0), the temporal-fusion Encoder2 (stage 1), TFR U-Nets on
    the center frames (stage 2)."""

    def __init__(self, cfg: GShiftNetConfig):
        super().__init__()
        if cfg.time_group is not None and (cfg.past_frames
                                           or cfg.future_frames):
            # gshift.py:312-319: each rank predicts all of its frames
            raise ValueError('a model on a time ring needs past_frames = '
                             'future_frames = 0')
        self.cfg = cfg
        nf0 = cfg.n_feats0
        fused = cfg.fused_chw
        tfr_kw = dict(kernel_size=3, reduction=cfg.ca_reduction,
                      scale_unetfeats=cfg.tfr_scale,
                      downsample_prelu=cfg.downsample_prelu,
                      fused=cfg.fused_tfr or fused)
        self.feat_extract = nn.Sequential(
            Conv2d(cfg.in_channels, nf0, 3, bias=True, fused=fused),
            CAB(nf0, 3, cfg.ca_reduction, fused=fused))
        for i in range(cfg.num_orbs):
            self.add_module(f'orb{i + 1}', TFRUNet(nf0, **tfr_kw))
        self.conv_trans = Conv2d(nf0, nf0, 3, bias=True, fused=fused)
        self.stage1 = Encoder2(cfg)
        self.rconcat = Conv2d(3 * nf0, nf0, 3, bias=cfg.rconcat_bias,
                              fused=fused)
        if cfg.rconcat_act:
            self.lrelu = PReLU()
        for i in range(cfg.num_orbs):
            self.add_module(f'rorb{i + 1}', TFRUNet(nf0, **tfr_kw))
        self.conv_last = Conv2d(nf0, 3, cfg.conv_last_ks, fused=fused)

    def _orbs(self, prefix: str, y):
        for i in range(self.cfg.num_orbs):
            orb = self.get_submodule(f'{prefix}{i + 1}')
            y = (checkpoint(orb, y, use_reentrant=False)
                 if torch.is_grad_enabled() else orb(y))
        return y

    def forward(self, x, noise_map=None):
        """x: (T, 3, H, W) in the compute type -> (T - past - future, 3, H,
        W).  The denoise variants take ``noise_map`` (T, 1, H, W), which is
        concatenated to x as a fourth input channel."""
        cfg = self.cfg
        t = x.shape[0]
        center = slice(cfg.past_frames, t - cfg.future_frames)
        if cfg.noise_map:
            if noise_map is None:
                raise ValueError(f'{cfg.name} takes a noise map')
            x0 = self.feat_extract(
                torch.cat([x, noise_map.to(x.dtype)], dim=1))
        else:
            x0 = self.feat_extract(x)
        y = self._orbs('orb', x0)
        feats = y + x0 if cfg.stage_residual else y  # sam_features0
        del y
        if cfg.stage2_uses_conv_trans:  # stage2 reads conv_trans's output
            feats = self.conv_trans(feats)
            dec = self.stage1(feats)
        else:  # conv_trans's output dies inside stage1
            dec = self.stage1(self.conv_trans(feats))
        parts = [x0[center], feats[center], dec[center]]
        del x0, dec, feats
        # rconcat, with the PReLU after it (denoise) inside the launch
        z = self.rconcat.forward_cat(
            parts, self.lrelu.weight if cfg.rconcat_act else None,
            virtual=cfg.conv_concat)
        del parts
        y = self._orbs('rorb', z)
        if cfg.stage_residual:
            y = y + z
        del z
        return self.conv_last(y) + x[center]


def build_model(name: str, **overrides) -> GShiftNet:
    cfg = CONFIGS[name].replace(**overrides) if overrides else CONFIGS[name]
    return GShiftNet(cfg)


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``model``'s parameters in place with ``init_state(model,
    seed)``, the port's seeded parameter init (the role of
    ``shiftnet_tpu/models/__init__.py:init_params``); returns the model."""
    model.load_state_dict(init_state(model, seed), strict=True)
    return model


def init_state(model: nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random weights for a model with no checkpoint, keyed like its
    ``state_dict``: conv weights U(+-1/sqrt(fan_in)), biases 0.01 N(0, 1),
    PReLU slopes 0.25, LayerNorm 1 / 0, CAB1/CAB2 beta 0.1 N(0, 1) (a zero
    beta would make every shift block an identity).  Each tensor draws from
    its own numpy generator seeded by (seed, key), so the values do not
    depend on the order of the keys."""
    state = {}
    for key, p in model.state_dict().items():
        digest = hashlib.sha256(f'{seed}:{key}'.encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:8], 'little'))
        shape = tuple(p.shape)
        if key.endswith('.beta'):
            v = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 4:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            v = rng.uniform(-bound, bound, shape)
        elif shape == (1,):
            v = np.full(shape, 0.25)
        elif key.endswith('.bias') and '.norm.' in key:
            v = np.zeros(shape)
        elif key.endswith('.bias'):
            v = 0.01 * rng.standard_normal(shape)
        elif key.endswith('.weight'):  # LayerNorm2d scale
            v = np.ones(shape)
        else:
            raise ValueError(f'init_state: unhandled parameter {key} {shape}')
        state[key] = torch.from_numpy(v.astype(np.float32))
    return state
