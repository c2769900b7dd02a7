"""The port's shift-block ops (``shiftnet_tpu_torch/ops/naf_chw.py``) against
the JAX package on the CPU.

On the CPU each op runs its plain PyTorch version.  ``shift_round_plain``
is held bit for bit against the JAX shifts (``shiftnet_tpu/ops/shift.py``).
``naf_cab`` (CAB2 and CAB1 as gate -> rep -> back) is held in float32
against the XLA twin of the Pallas kernels (``chw_xla.naf_cab_chw_xla``,
normalized max error <= 1e-5) and against the unfused flax CAB2 / CAB1
(<= 1e-4: they round at other points, which float32 hides), on a ragged
frame with signal at every border and a LayerNorm whose bias is not zero:
LayerNorm of a zero pixel is then not zero, so a missing halo mask shows.
The CUDA kernels are held against the plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shiftnet_tpu.models import layers as jl
from shiftnet_tpu.ops import chw as jchw
from shiftnet_tpu.ops import chw_xla
from shiftnet_tpu.ops import naf_chw as jnaf
from shiftnet_tpu.ops import shift as jshift
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from shiftnet_tpu_torch.models import init_state, layers
from shiftnet_tpu_torch.ops import chw, naf_chw

CPU = jax.devices('cpu')[0]


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = jax.config.jax_default_device
    jax.config.update('jax_default_device', CPU)
    yield
    jax.config.update('jax_default_device', prev)


def norm_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.std(b)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def to_nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def to_nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


@pytest.mark.parametrize('number', [3, 5])  # C = 48 (1 channel per group), 80
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('patch', [False, True])
def test_shift_round_plain_is_bit_exact(number, reverse, patch):
    c, add_c = 16 * number, 8 * number
    x = rand((4, c, 19, 21), number)
    chw.reset_launches()
    y, hw = naf_chw.shift_round(torch.from_numpy(x), number,
                                reverse=reverse, boundary_patch=patch)
    assert chw.LAUNCHES['shift_round'] == 0  # CPU tensors: the plain version
    jy = jshift.temporal_channel_shift(jnp.asarray(to_nhwc(x)),
                                       reverse=reverse, boundary_patch=patch)
    jhw = jshift.grouped_spatial_shift(
        jy[..., -add_c:] if reverse else jy[..., :add_c], number)
    np.testing.assert_array_equal(y.numpy(), to_nchw(jy))
    np.testing.assert_array_equal(hw.numpy(), to_nchw(jhw))


def naf_module(n, cab2, mid_ca, last_bias, seed, reduction=4,
               depthwise=False):
    """A port CAB2 / CAB1 with seeded weights whose LayerNorm is not the
    identity, beta is O(1) and the last bias (if any) is not zero;
    ``depthwise``: the small variants' depthwise RepConv."""
    kw = dict(kernel_size=5, reduction=reduction, mid_ca=mid_ca,
              last_bias=last_bias, repconv_depthwise=depthwise)
    add_c = 8 * (n // 16)
    mod = layers.CAB2(n, add_c, **kw) if cab2 else layers.CAB1(n, **kw)
    state = init_state(mod, seed)
    rng = np.random.default_rng(seed)
    for key, v in state.items():
        if key.startswith('norm.') or key.endswith('.bias'):
            state[key] = v + torch.from_numpy(
                0.3 * rng.standard_normal(v.shape).astype(np.float32))
        elif key == 'beta':
            state[key] = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
    mod.load_state_dict(state, strict=True)
    fmod = (jl.CAB2(n, add_c, **kw) if cab2 else jl.CAB1(n, **kw))
    return mod, fmod, state, add_c


NAF_CASES = [  # n, CAB2, mid_ca and last_bias (opts), depthwise RepConv
    pytest.param(n, cab2, opts, False, id=f'{n}-{cab2}-{opts}')
    for n, cab2, opts in ((48, True, False), (48, False, False),
                          (80, True, False), (80, False, False),
                          (48, True, True), (80, False, True))
] + [  # the small variants' blocks: opts off is deblur_small's (CALayer
    # reduction 1), on is denoise_small's (reduction 4)
    pytest.param(n, cab2, opts, True, id=f'{n}-{cab2}-{opts}-depthwise')
    for n in (32, 64) for cab2 in (True, False) for opts in (False, True)
]


@pytest.mark.parametrize('n,cab2,opts,depthwise', NAF_CASES)
def test_naf_cab_matches_xla_twin_and_flax(n, cab2, opts, depthwise):
    t, h, w = 2, 19, 37  # ragged: no tile or row stride divides it
    mod, fmod, state, add_c = naf_module(
        n, cab2, opts, opts, seed=n + cab2,
        reduction=1 if depthwise and not opts else 4, depthwise=depthwise)
    y = rand((t, n, h, w), 1)
    hw = rand((t, add_c, h, w), 2) if cab2 else None
    yt = torch.from_numpy(y)
    with torch.no_grad():
        got = naf_chw.naf_cab(
            dict(mod.named_parameters()), '', yt,
            None if hw is None else torch.from_numpy(hw), mid_ca=opts,
            last_bias=opts).numpy()
    np.testing.assert_array_equal(yt.numpy(), y)  # not in place by default

    yn = jnp.asarray(to_nhwc(y))
    args = (yn,) if hw is None else (yn, jnp.asarray(to_nhwc(hw)))
    tpl = jax.eval_shape(
        lambda: fmod.init(jax.random.PRNGKey(0), *args))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    naf = jnaf.naf_params_from_tree(params, mid_ca=opts, last_bias=opts,
                                    add_c=add_c if cab2 else 0)

    @jax.jit
    def twin(naf, *a):
        out = chw_xla.naf_cab_chw_xla(
            jchw.from_nhwc(a[0], padr=4, pf=1),
            jchw.from_nhwc(a[1], padr=4, pf=1) if cab2 else None, naf,
            groups=n if depthwise else n // 8, mid_ca=opts,
            use_last_bias=opts)
        return jchw.to_nhwc(out)

    assert norm_err(got, to_nchw(twin(naf, *args))) < 1e-5
    flax_out = jax.jit(fmod.apply)({'params': params}, *args)
    assert norm_err(got, to_nchw(flax_out)) < 1e-4
    with torch.no_grad():  # the port's own unfused module
        layer_out = (mod(yt, torch.from_numpy(hw)) if cab2 else mod(yt))
    assert norm_err(layer_out.numpy(), to_nchw(flax_out)) < 1e-4


def test_prep_naf_matches_prep_naf_weights():
    n, add_c = 48, 24
    mod, fmod, state, _ = naf_module(n, True, False, False, seed=5)
    prep = naf_chw.prep_naf(dict(mod.named_parameters()), '', torch.float32)
    y = jnp.zeros((1, 4, 4, n))
    tpl = jax.eval_shape(lambda: fmod.init(
        jax.random.PRNGKey(0), y, jnp.zeros((1, 4, 4, add_c))))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    naf = jnaf.naf_params_from_tree(params, add_c=add_c)
    hcb = 32  # add_c padded to a multiple of 16
    want = jnaf.prep_naf_weights(naf, n, add_c, n // 8, jnp.float32, n, hcb)
    half = n // 2
    wg = prep['wg'].t().numpy()  # (2n, cin)
    for k in range(2):  # the TPU kernel's two SimpleGate chunks
        rows = np.r_[k * half:(k + 1) * half, n + k * half:n + (k + 1) * half]
        np.testing.assert_allclose(prep['c1'].numpy()[rows],
                                   np.asarray(want['c1'][k, :, 0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(prep['c2'].numpy()[rows],
                                   np.asarray(want['c2'][k, :, 0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(wg[rows, :n],
                                      np.asarray(want['wa'][k, :n, :n]))
        np.testing.assert_array_equal(wg[rows, n:],
                                      np.asarray(want['wb'][k, :n, :add_c]))
    # The merged grouped RepConv, densified as the TPU kernel takes it:
    # dense[o, tap * n + 8 * (o // 8) + j] = rep[o, j, tap].
    rep = prep['rep'].reshape(n, 8, 25).numpy()
    dense = np.zeros((n, 25, n), np.float32)
    for o in range(n):
        dense[o, :, 8 * (o // 8):8 * (o // 8) + 8] = rep[o].T
    np.testing.assert_allclose(dense.reshape(n, 25 * n),
                               np.asarray(want['rep']), rtol=0, atol=1e-7)


def test_prep_naf_depthwise_matches_dense_rep():
    """The small variants' depthwise RepConv: ``rep`` (n, 1, 5, 5), merged
    as ``_dense_rep`` merges it, which the port keeps depthwise and the TPU
    kernel takes as a diagonal block matrix."""
    n, add_c = 64, 32
    mod, fmod, state, _ = naf_module(n, True, False, False, seed=8,
                                     reduction=1, depthwise=True)
    prep = naf_chw.prep_naf(dict(mod.named_parameters()), '', torch.float32)
    assert prep['rep'].shape == (n, 1, 5, 5)
    y = jnp.zeros((1, 4, 4, n))
    tpl = jax.eval_shape(lambda: fmod.init(
        jax.random.PRNGKey(0), y, jnp.zeros((1, 4, 4, add_c))))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    naf = jnaf.naf_params_from_tree(params, add_c=add_c)
    want = jnaf.prep_naf_weights(naf, n, add_c, n, jnp.float32, n, add_c)
    # densified: dense[o, tap * n + o] = rep[o, 0, tap]
    rep = prep['rep'].reshape(n, 25).numpy()
    dense = np.zeros((n, 25, n), np.float32)
    dense[np.arange(n), :, np.arange(n)] = rep
    np.testing.assert_allclose(dense.reshape(n, 25 * n),
                               np.asarray(want['rep']), rtol=0, atol=1e-7)


def test_encoder_shift_block_fused_matches_unfused_and_keeps_its_input():
    n = 48
    blk = layers.EncoderShiftBlock(n, rounds=2, fused=True)
    blk.load_state_dict(init_state(blk, 6), strict=True)
    x = torch.from_numpy(rand((4, n, 12, 20), 7))
    x0 = x.clone()
    params = {k: v.clone() for k, v in blk.state_dict().items()}
    with torch.no_grad():
        got = blk(x)
        blk.fused = False
        want = blk(x)
    assert torch.equal(x, x0)
    # prep_naf works on copies: the weights are not written either
    assert all(torch.equal(v, params[k]) for k, v in blk.state_dict().items())
    assert norm_err(got.numpy(), want.numpy()) < 1e-5


def test_gate_and_rep_tiles_fit_shared_memory():
    for n, add_c in ((48, 24), (80, 40), (48, 0), (80, 0), (64, 32), (64, 0)):
        for itemsize in (2, 4):
            th, tw = naf_chw.naf_gate_tile(n, add_c, itemsize)
            smem = naf_chw.naf_gate_smem(n, add_c, itemsize, th, tw)
            assert smem <= chw.SMEM_BYTES and tw % 8 == 0
            if itemsize == 2:  # two blocks an SM
                assert smem <= chw.TWO_PER_SM
            # the g tile fits over the staged [y; hw2]
            m1 = (th + 2) * (tw + 2)
            assert n * (th * tw + naf_chw.SBUF_PAD) <= max(
                m1 * chw.mma_pitch(n + add_c, itemsize),
                n * (th * tw + naf_chw.SBUF_PAD))
    for n, group in ((48, 8), (80, 8), (64, 1), (32, 1)):
        for itemsize in (2, 4):
            th, tw = naf_chw.naf_rep_tile(n, itemsize, group)
            smem = naf_chw.naf_rep_smem(n, itemsize, th, tw, group)
            assert smem <= chw.SMEM_BYTES and tw % 8 == 0
            if itemsize == 2:
                assert smem <= chw.TWO_PER_SM
    # the sizes and tiles of the model widths, as csrc/naf_gate.cu and
    # naf_rep.cu lay them out (tools/bench_conv.py --tiles measured the
    # picks): naf_gate n = 80 bf16 8x8 = panel 160 x 120, [y; hw2] 100 x
    # 120, e 100 x 168, and float32 LN statistics and c1, c2
    assert naf_chw.naf_gate_tile(80, 40, 2) == (8, 8)
    assert naf_chw.naf_gate_smem(80, 40, 2, 8, 8) == 98080 == (
        (160 * 120 + 100 * 120 + 100 * 168) * 2 + (2 * 100 + 4 * 80) * 4)
    assert naf_chw.naf_gate_tile(80, 40, 4) == (8, 8)
    assert naf_chw.naf_gate_smem(80, 40, 4, 8, 8) == 198240
    assert naf_chw.naf_gate_tile(64, 32, 2) == (8, 16)
    # naf_rep: g 12 x 12 (and 2-pixel halo) x 88, r 64 x 88, the groups'
    # panels 10 x 25 x 8 x 8, the expand's 160 x 88
    assert naf_chw.naf_rep_tile(80, 2, 8) == (8, 8)
    assert naf_chw.naf_rep_smem(80, 2, 8, 8, 8) == 96768 == (
        144 * 88 + 64 * 88 + 10 * 25 * 8 * 8 + 160 * 88) * 2
    assert naf_chw.naf_rep_smem(80, 4, 8, 8, 8) == 219648
    assert naf_chw.naf_rep_tile(64, 2, 1) == (16, 16)


def norm_t(a, b):
    return norm_err(a.numpy(), b.numpy())


WIDTHS = [pytest.param(n, size, id=f'{n}-{size}') for n in (48, 64, 80)
          for size in (2, 4)]
DTYPE = {2: torch.bfloat16, 4: torch.float32}


@pytest.mark.parametrize('n,itemsize', WIDTHS)
def test_packed_expand_panels_rebuild_the_expands(n, itemsize):
    """naf_gate's panel ``wg_p`` (output channels in order) and naf_rep's
    ``w4_p`` (the gate interleave of ``gate_rows``) rebuild
    ``einsum('io,tihw->tohw', w, x)`` from their rows; each 16 rows of
    ``w4_p`` hold 8 channels o and then their SimpleGate2 partners o + n;
    padding is zero and a row is an odd number of 16-byte units."""
    mod, _, _, add_c = naf_module(n, True, False, False, seed=n + itemsize)
    prep = naf_chw.prep_naf(dict(mod.named_parameters()), '',
                            DTYPE[itemsize])
    cin = n + add_c
    rows = naf_chw.gate_rows(n)
    assert sorted(rows.tolist()) == list(range(2 * n))
    r = torch.arange(2 * n)
    first = (r % 16) < 8
    assert torch.equal(rows[r[~first]], rows[r[first]] + n)
    for key, w, c_in, order in (('wg_p', prep['wg'], cin, r),
                                ('w4_p', prep['w4'], n, rows)):
        panel = prep[key]
        np_, kp = chw.mma_layout(c_in, 2 * n, itemsize, expand=True)
        assert panel.shape == (1, np_, kp) and panel.dtype == DTYPE[itemsize]
        assert (kp * itemsize // 16) % 2 == 1 and not panel[..., c_in:].any()
        x = torch.from_numpy(rand((2, c_in, 5, 7), n))
        want = torch.einsum('io,tihw->tohw', w, x)
        got = torch.einsum('ri,tihw->trhw', panel[0, :, :c_in].float(), x)
        assert norm_t(got, want[:, order]) < 1e-5  # float32, reordered


@pytest.mark.parametrize('n,itemsize', WIDTHS)
def test_packed_group_panels_rebuild_the_grouped_conv(n, itemsize):
    """``rep_p`` (``pack_groups``: per group and tap, 8 output rows of the
    group's 8 input channels) rebuilds ``F.conv2d(x, rep, groups=n // 8)``
    as a sum over the 25 taps of each group's shifted 8 x 8 product."""
    mod, _, _, _ = naf_module(n, True, False, False, seed=2 * n + itemsize)
    prep = naf_chw.prep_naf(dict(mod.named_parameters()), '',
                            DTYPE[itemsize])
    panels = prep['rep_p']
    kp = chw.mma_pitch(8, itemsize)
    assert panels.shape == (n // 8, 25, 8, kp)
    assert panels.dtype == DTYPE[itemsize] and not panels[..., 8:].any()
    x = torch.from_numpy(rand((2, n, 9, 11), n))
    want = F.conv2d(x, prep['rep'], padding=2, groups=n // 8)
    xp = F.pad(x, (2, 2, 2, 2))
    got = torch.zeros_like(want)
    for grp in range(n // 8):
        ch = slice(8 * grp, 8 * grp + 8)
        for tap in range(25):
            ky, kx = divmod(tap, 5)
            win = xp[:, ch, ky:ky + 9, kx:kx + 11]
            got[:, ch] += torch.einsum(
                'oj,tjhw->tohw', panels[grp, tap, :, :8].float(), win)
    assert norm_t(got, want) < 1e-5  # float32 sums of 200 terms, reordered
    dw, _, _, _ = naf_module(64, True, False, False, seed=1, depthwise=True)
    prep = naf_chw.prep_naf(dict(dw.named_parameters()), '', DTYPE[itemsize])
    assert prep['rep_p'] is None  # depthwise: the CUDA cores read rep


@pytest.mark.parametrize('n,itemsize', WIDTHS)
@pytest.mark.parametrize('last_bias', [False, True])
def test_w7_panel_unpacks_to_the_rounded_projection(n, itemsize, last_bias):
    """naf_back's panel ``w7_p`` (csrc/naf_back.cu reads it as the B operand
    of its one-tap product): row o holds output channel o's weights over
    the input channels, exactly the projection rounded to the compute type
    (``w7`` is input-major); the padding columns are zero and a row is an
    odd number of 16-byte units.  b7 does not enter the panel."""
    mod, _, _, _ = naf_module(n, False, False, last_bias, seed=3 * n)
    dt = DTYPE[itemsize]
    params = dict(mod.named_parameters())
    prep = naf_chw.prep_naf(params, '', dt, last_bias=last_bias)
    panel = prep['w7_p']
    np_, kp = chw.mma_layout(n, n, itemsize)
    assert np_ == n and panel.shape == (1, n, kp) and panel.dtype == dt
    assert (kp * itemsize // 16) % 2 == 1 and not panel[..., n:].any()
    want = params['body.7.weight'].detach().flatten(1).to(dt)
    assert torch.equal(panel[0, :, :n], want)
    assert torch.equal(panel[0, :, :n].float(), prep['w7'].t())
    assert (prep['b7'] is not None) == last_bias


def test_back_fits_shared_memory():
    """naf_back's block at every width, as csrc/naf_back.cu lays it out: two
    stages of s and y [n][cm_pitch(128)] and ca, then the panel; in
    bfloat16 two blocks share an SM."""
    for n in (32, 48, 64, 80):
        for itemsize in (2, 4):
            smem = naf_chw.naf_back_smem(n, itemsize)
            assert smem <= chw.SMEM_BYTES
            if itemsize == 2:
                assert smem <= chw.TWO_PER_SM
    assert chw.cm_pitch(128) == 136 and chw.cm_pitch(612) == 632
    assert naf_chw.naf_back_smem(80, 2) == (
        2 * (2 * 80 * 136 + 80) + 80 * 88) * 2 == 101440
    assert naf_chw.naf_back_smem(80, 4) == 201600


def test_expand_layouts_match_the_dispatch_table():
    """``mma_layout(..., expand=True)`` takes exactly the expand rows of
    ``dispatch_np<true>`` in csrc/conv_core.cuh (two warp columns of an
    even number of n8 tiles each: a gate pair in one warp): Np = 2n for n
    = 32, 48, 64, 80; the plain layout still stops at 112."""
    src = (Path(chw.__file__).parents[1] / 'csrc' / 'conv_core.cuh'
           ).read_text()
    block = src[src.index('if constexpr (kExpand)'):src.index('} else {',
                                                            src.index(
        'if constexpr (kExpand)'))]
    table = [tuple(map(int, m)) for m in
             re.findall(r'SHIFTNET_NP\((\d+), (\d+), (\d+)\)', block)]
    assert [np_ for np_, _, _ in table] == list(chw.EXPAND_NP)
    assert all(wn == 2 and ntw % 2 == 0 and np_ == 8 * ntw * wn
               for np_, ntw, wn in table)
    for n in (32, 48, 64, 80):
        for size in (2, 4):
            assert chw.mma_layout(n, 2 * n, size, expand=True) == (
                2 * n, chw.mma_pitch(n, size))
    for np_ in (96, 128, 160):
        assert np_ in chw.EXPAND_NP
    for c_out in (128, 160):
        with pytest.raises(ValueError, match='112'):
            chw.mma_layout(80, c_out, 2)
    with pytest.raises(ValueError, match='expand'):
        chw.mma_layout(40, 80, 2, expand=True)


@pytest.mark.parametrize('tool', ['bench_conv', 'phase_naf'])
def test_naf_timing_tools_need_the_card(tool, monkeypatch):
    """The tools that time the naf kernels raise without a CUDA device (no
    number is taken on the CPU), and phase_naf adds its build flag only
    once it has a card."""
    from shiftnet_tpu_torch.ops import _build
    mod = importlib.import_module(f'shiftnet_tpu_torch.tools.{tool}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    flags = list(_build.NVCC_FLAGS)
    with pytest.raises(SystemExit, match='needs a CUDA device'):
        mod.main(['--only', 'naf'] if tool == 'bench_conv' else [])
    assert _build.NVCC_FLAGS == flags
