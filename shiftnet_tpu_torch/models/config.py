"""GShiftNet configuration: the four reference variants.

Re-declared from ``shiftnet_tpu/models/gshift.py:29-111`` (that module
imports flax).  ``stage2_chunk`` (a memory knob for 16 GB of HBM) is not
declared; JAX's ``time_axis`` (a mesh axis name) is ``time_group`` here, a
``torch.distributed`` process group.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GShiftNetConfig:
    """Static architecture configuration covering the 4 reference variants."""
    name: str = 'deblur_plus'
    in_channels: int = 3          # 4 for denoise (RGB + noise map)
    n_feats0: int = 24            # full-res width (14 small)
    n_feats2: int = 80            # Encoder2 width (64 small)
    num_orbs: int = 5             # TFR_UNets per stage0/stage2 (3 small)
    tfr_scale: int = 12           # TFR_UNet width increment per level
    shift_rounds: int = 8         # GSTS rounds per shift block (4 small)
    encoder2_levels: int = 3      # U-Net depth of Encoder2 (2 small)
    encoder2_shift_encoder: bool = False   # small: shift blocks in encoder
    encoder2_level0_shift_cabs: bool = False  # denoise+: Shift_CABs at L0
    encoder2_level1_shift_cabs: bool = False  # denoise+: Shift_CABs at L1
    final_fuse_concat: bool = True  # concat+conv_hr0 (vs add, deblur-small)
    boundary_patch: bool = True     # patch boundary frames in temporal shift
    cab_mid_ca: bool = False        # denoise: extra CALayer2 after SimpleGate
    cab_last_bias: bool = False     # denoise: biased final 1x1 in CAB1/CAB2
    ca_reduction: int = 4           # 1 for deblur-small
    repconv_depthwise: bool = False  # small: fully-depthwise RepConv
    downsample_prelu: bool = False   # denoise: DownSample bias=False + PReLU
    stage_residual: bool = True      # deblur: stage0/stage2 shortcuts
    stage2_uses_conv_trans: bool = False  # denoise: stage2 gets sam_features
    rconcat_bias: bool = True
    rconcat_act: bool = False       # denoise: PReLU after rconcat
    conv_last_ks: int = 5           # 3 for denoise
    past_frames: int = 1            # num_fb (2 at deblur test time)
    future_frames: int = 1          # num_ff
    fused_tfr: bool = False         # TFR U-Nets on the CUDA kernels (ops/chw)
    fused_chw: bool = False         # the whole network on the CUDA kernels
    # (ops/chw, ops/naf_chw): every CAB, standalone conv, SkipUpSample and
    # shift block; implies fused_tfr
    conv_concat: bool = False       # fused_chw only: rconcat and conv_hr0
    # as one conv_cat launch over their inputs (ops.chw.conv_concat), so
    # the 3*nf0 / 2*nf0 channel concat is never allocated
    # Sequence parallelism (gshift.py:74): the time ring over which a
    # clip's frames are split; every temporal shift exchanges its edge
    # frame over it.  Needs past_frames = future_frames = 0.
    time_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)

    @property
    def noise_map(self) -> bool:
        return self.in_channels == 4

    def replace(self, **kw) -> 'GShiftNetConfig':
        return dataclasses.replace(self, **kw)


DEBLUR_PLUS = GShiftNetConfig(name='deblur_plus')
DEBLUR_SMALL = GShiftNetConfig(
    name='deblur_small', n_feats0=14, n_feats2=64, num_orbs=3, tfr_scale=4,
    shift_rounds=4, encoder2_levels=2, encoder2_shift_encoder=True,
    final_fuse_concat=False, boundary_patch=False, ca_reduction=1,
    repconv_depthwise=True)
DENOISE_PLUS = GShiftNetConfig(
    name='denoise_plus', in_channels=4, encoder2_level0_shift_cabs=True,
    encoder2_level1_shift_cabs=True, cab_mid_ca=True, cab_last_bias=True,
    downsample_prelu=True, stage_residual=False, stage2_uses_conv_trans=True,
    rconcat_bias=False, rconcat_act=True, conv_last_ks=3,
    past_frames=0, future_frames=0)
DENOISE_SMALL = GShiftNetConfig(
    name='denoise_small', in_channels=4, n_feats0=14, n_feats2=64, num_orbs=3,
    tfr_scale=4, shift_rounds=4, encoder2_levels=2,
    encoder2_shift_encoder=True, cab_mid_ca=True, cab_last_bias=True,
    downsample_prelu=True, repconv_depthwise=True, stage_residual=False,
    stage2_uses_conv_trans=True, rconcat_bias=False, rconcat_act=True,
    conv_last_ks=3, past_frames=0, future_frames=0)

CONFIGS = {c.name: c for c in
           (DEBLUR_PLUS, DEBLUR_SMALL, DENOISE_PLUS, DENOISE_SMALL)}
