"""The port's TFR U-Net ops (``shiftnet_tpu_torch/ops/chw.py``) against the
JAX package on the CPU.

On the CPU each op runs its plain PyTorch version; those are held here
against the XLA twins of the Pallas kernels (``shiftnet_tpu/ops/chw_xla.py``,
on packed ``ChwTensor`` inputs) and against the unfused flax modules, in
float32 at normalized max error <= 1e-5.  The CUDA kernels themselves are
held against the plain versions on the card (tests marked ``cuda``, and
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from shiftnet_tpu.models import layers as jl
from shiftnet_tpu.ops import chw as jchw
from shiftnet_tpu.ops import chw_xla
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from shiftnet_tpu_torch.models import layers, init_state
from shiftnet_tpu_torch.ops import _build, chw

CPU = jax.devices('cpu')[0]
TOL = 1e-5


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


def seeded(module, seed=0):
    """Load seeded weights into a port module; returns its state."""
    state = init_state(module, seed)
    module.load_state_dict(state, strict=True)
    return state


def flax_params(module, state, *args):
    """A flax module's parameter tree, shaped by ``jax.eval_shape`` of its
    init and filled from the port's torch-keyed state."""
    tpl = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))['params']
    return torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                               tpl)


@pytest.mark.parametrize('pf', [1, 4])
def test_cab_plain_matches_xla_twin_and_flax(pf):
    t, c, h, w = 2, 12, 16, 24
    x = rand((t, c, h, w), 1)
    wrap = nn.Sequential(layers.CAB(c, 3, 4))
    state = {k.split('.', 1)[1]: v for k, v in seeded(wrap).items()}
    with torch.no_grad():
        got = chw.cab(dict(wrap.named_parameters()), '0',
                      torch.from_numpy(x))
    fmod = jl.CAB(c, kernel_size=3, reduction=4)
    xn = jnp.asarray(to_nhwc(x))
    params = flax_params(fmod, state, xn)
    twin = chw_xla.cab_chw_xla(jchw.from_nhwc(xn, padr=2, pf=pf), params,
                               reduction=4)
    assert norm_err(got.numpy(), to_nchw(jchw.to_nhwc(twin))) < TOL
    flax_out = fmod.apply({'params': params}, xn)
    assert norm_err(got.numpy(), to_nchw(flax_out)) < TOL
    with torch.no_grad():  # the port's layer path
        layer_out = wrap(torch.from_numpy(x))
    assert norm_err(layer_out.numpy(), to_nchw(flax_out)) < TOL


def test_cab_front_plain_sums_are_channel_sums():
    x = torch.from_numpy(rand((2, 8, 6, 10), 2))
    w1 = torch.from_numpy(0.2 * rand((8, 8, 3, 3), 3))
    w2 = torch.from_numpy(0.2 * rand((8, 8, 3, 3), 4))
    s, sums = chw.cab_front(x, w1, torch.tensor([0.25]), w2)
    assert sums.dtype == torch.float32 and sums.shape == (2, 8)
    torch.testing.assert_close(sums, s.sum(dim=(2, 3)))


@pytest.mark.parametrize('k', [2, 3, 5])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('bias,prelu', [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_conv_plain_matches_xla_twin(k, stride, bias, prelu):
    t, cin, cout, h, w = 2, 6, 10, 16, 24
    x = rand((t, cin, h, w), 5)
    wt = (rand((cout, cin, k, k), 6) / np.sqrt(cin * k * k)).astype(
        np.float32)
    b = 0.1 * rand((cout,), 7) if bias else None
    a = np.array([0.3], np.float32) if prelu else None
    got = chw.conv(torch.from_numpy(x), torch.from_numpy(wt),
                   None if b is None else torch.from_numpy(b),
                   None if a is None else torch.from_numpy(a), stride)
    xc = jchw.from_nhwc(jnp.asarray(to_nhwc(x)), padr=4, pf=2)
    twin = chw_xla.conv_chw_xla(
        xc, jnp.asarray(np.transpose(wt, (2, 3, 1, 0))),
        None if b is None else jnp.asarray(b),
        None if a is None else jnp.asarray(a), stride=stride)
    want = to_nchw(jchw.to_nhwc(twin))
    # The packed conv keeps the grid's extent; torch's padding rule gives
    # H+1 rows for k=2 s=1 and H/2-1 for k=5 s=2.  They agree where both
    # are defined.
    ho = min(got.shape[2], want.shape[2])
    wo = min(got.shape[3], want.shape[3])
    assert abs(got.shape[2] - want.shape[2]) <= 2
    assert norm_err(got[:, :, :ho, :wo].numpy(), want[:, :, :ho, :wo]) < TOL


@pytest.mark.parametrize('n_in', [2, 3])
@pytest.mark.parametrize('bias,prelu', [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_conv_concat_plain_matches_xla_twin_and_cat_conv(n_in, bias, prelu):
    t, cin, cout, h, w = 2, 6, 10, 16, 24
    xs = [rand((t, cin, h, w), 20 + j) for j in range(n_in)]
    ws = [(rand((cout, cin, 3, 3), 30 + j) / np.sqrt(9 * cin * n_in)).astype(
        np.float32) for j in range(n_in)]
    b = 0.1 * rand((cout,), 40) if bias else None
    a = np.array([0.3], np.float32) if prelu else None
    tb = None if b is None else torch.from_numpy(b)
    ta = None if a is None else torch.from_numpy(a)
    chw.reset_launches()
    wcat = torch.from_numpy(np.concatenate(ws, axis=1))
    got = chw.conv_concat([torch.from_numpy(x) for x in xs], wcat, tb, ta)
    assert chw.LAUNCHES['conv_cat'] == 0  # CPU tensors: the plain version
    twin = chw_xla.conv_concat_chw_xla(
        [jchw.from_nhwc(jnp.asarray(to_nhwc(x)), padr=4, pf=2) for x in xs],
        [jnp.asarray(np.transpose(k, (2, 3, 1, 0))) for k in ws],
        None if b is None else jnp.asarray(b),
        None if a is None else jnp.asarray(a))
    assert norm_err(got.numpy(), to_nchw(jchw.to_nhwc(twin))) < TOL
    cat = chw.conv(torch.from_numpy(np.concatenate(xs, axis=1)), wcat, tb,
                   ta, 1)
    assert norm_err(got.numpy(), cat.numpy()) < TOL


def test_up_skip_plain_matches_xla_twin_and_flax():
    t, cin, cout, h, w = 2, 12, 8, 8, 12
    x = rand((t, cin, h, w), 8)
    skip = rand((t, cout, 2 * h, 2 * w), 9)
    mod = layers.SkipUpSample(cin, cout)
    state = seeded(mod, 1)
    got = chw.up_skip(torch.from_numpy(x), mod.up[1].weight.detach(),
                      torch.from_numpy(skip))
    fmod = jl.SkipUpSample(cout)
    xn, sn = jnp.asarray(to_nhwc(x)), jnp.asarray(to_nhwc(skip))
    params = flax_params(fmod, state, xn, sn)
    twin = chw_xla.up_skip_chw_xla(jchw.from_nhwc(xn, padr=2, pf=1), params,
                                   jchw.from_nhwc(sn, padr=2, pf=2))
    assert norm_err(got.numpy(), to_nchw(jchw.to_nhwc(twin))) < TOL
    flax_out = fmod.apply({'params': params}, xn, sn)
    assert norm_err(got.numpy(), to_nchw(flax_out)) < TOL


@pytest.mark.parametrize('downsample_prelu', [False, True])
def test_tfr_unet_matches_flax(downsample_prelu):
    t, c0, h, w = 2, 8, 16, 24
    x = rand((t, c0, h, w), 10)  # random borders: every edge carries signal
    unet = layers.TFRUNet(c0, scale_unetfeats=4, reduction=4,
                          downsample_prelu=downsample_prelu, fused=True)
    state = seeded(unet, 2)
    xt = torch.from_numpy(x.copy())
    with torch.no_grad():
        got = unet(xt)
        unet.fused = False
        layer_out = unet(xt)
    np.testing.assert_array_equal(xt.numpy(), x)  # the input is not written
    fmod = jl.TFRUNet(c0, kernel_size=3, reduction=4, scale_unetfeats=4,
                      downsample_prelu=downsample_prelu)
    xn = jnp.asarray(to_nhwc(x))
    params = flax_params(fmod, state, xn)
    want = to_nchw(jax.jit(lambda p, v: fmod.apply({'params': p}, v))(
        params, xn))
    assert norm_err(got.numpy(), want) < TOL
    assert norm_err(layer_out.numpy(), want) < TOL


def test_ops_reject_other_devices():
    x = torch.empty((1, 4, 4, 4), device='meta')
    with pytest.raises(ValueError, match='device'):
        chw.cab_back(x, x, torch.empty((1, 4), device='meta'))


def test_cpu_tensors_take_the_plain_path_without_counting():
    chw.reset_launches()
    x = torch.from_numpy(rand((1, 8, 4, 6), 11))
    w = torch.from_numpy(0.1 * rand((8, 8, 3, 3), 12))
    s, sums = chw.cab_front(x, w, torch.tensor([0.25]), w)
    chw.cab_back(x, s, torch.sigmoid(sums))
    chw.conv(x, w, None, None, 2)
    chw.conv_concat([x, x], torch.cat([w, w], 1), None, torch.tensor([0.25]))
    chw.up_skip(x, torch.from_numpy(rand((8, 8, 1, 1), 13)),
                torch.from_numpy(rand((1, 8, 8, 12), 14)))
    assert set(chw.LAUNCHES.values()) == {0}


def test_cab_front_tile_fits_shared_memory():
    """Every CAB width of the four variants, in bfloat16 and float32: the
    tile fits a block's shared memory, the s tile fits over the input tile
    and its rows are 16-byte vectors (csrc/cab_front.cu); in bfloat16 two
    blocks share an SM."""
    for c in (14, 18, 22, 24, 36, 48, 64, 80):
        for itemsize in (2, 4):
            th, tw = chw.cab_front_tile(c, itemsize)
            assert chw.cab_front_smem(c, itemsize, th, tw) <= chw.SMEM_BYTES
            assert tw % 8 == 0
            assert c * (th * tw + 8) <= (th + 4) * (tw + 4) * chw.mma_pitch(
                c, itemsize)
        assert chw.cab_front_smem(c, 2, *chw.cab_front_tile(c, 2)) <= (
            chw.TWO_PER_SM)
    assert [chw.cab_front_tile(c, 2) for c in (14, 24, 36, 48, 64, 80)] == [
        (16, 32), (16, 32), (16, 16), (16, 16), (8, 16), (8, 16)]
    assert chw.cab_front_tile(80, 4) == (8, 16)
    with pytest.raises(ValueError, match='no tile'):
        chw.cab_front_tile(112, 4)


# (Cin, Cout, K, stride) of every conv the variants run on the kernels, then
# the CAB convs (C -> C, 3x3) at every CAB width.
CONV_SHAPES = [(24, 36, 3, 2), (36, 48, 3, 2), (24, 24, 3, 1), (24, 3, 5, 1),
               (3, 24, 3, 1), (4, 24, 3, 1), (24, 80, 2, 2), (14, 64, 2, 2),
               (80, 96, 3, 1), (64, 56, 3, 1), (72, 24, 3, 1), (14, 14, 3, 1),
               (80, 80, 3, 2), (64, 64, 3, 2), (3, 14, 3, 1), (14, 3, 5, 1)]
CAB_SHAPES = [(c, c, 3, 1) for c in (14, 18, 22, 24, 36, 48, 64, 80)]


@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('cin,cout,k,stride', CONV_SHAPES + CAB_SHAPES)
def test_packed_taps_rebuild_the_conv(cin, cout, k, stride, itemsize):
    """The tensor-core kernels' weight panels (``pack_taps``, at the
    bfloat16 and the float32 panel widths): a conv rebuilt from them as a
    sum over taps of shifted matmuls, over the input zero-padded to the
    panel width, equals ``F.conv2d``; the padding rows and columns are
    zero, and a panel row is an odd number of 16-byte units."""
    rng = np.random.default_rng(cin * 100 + cout + k)
    x = torch.from_numpy(rng.standard_normal((2, cin, 9, 13)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, k, k))
                          / np.sqrt(k * k * cin)).astype(np.float32))
    np_, kp = chw.mma_layout(cin, cout, itemsize)
    assert np_ >= cout and kp >= cin and (kp * itemsize // 16) % 2 == 1
    packed = chw.pack_taps(w, np_, kp)
    assert packed.shape == (k * k, np_, kp) and packed.is_contiguous()
    assert not packed[:, cout:].any() and not packed[:, :, cin:].any()
    pad = chw.conv_pad(k, stride)
    want = F.conv2d(x, w, stride=stride, padding=pad)
    ho, wo = want.shape[2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    xp = F.pad(xp, (0, 0, 0, 0, 0, kp - cin))  # channels to the panel width
    got = torch.zeros(2, np_, ho, wo)
    for tap in range(k * k):
        ky, kx = divmod(tap, k)
        win = xp[:, :, ky:ky + (ho - 1) * stride + 1:stride,
                 kx:kx + (wo - 1) * stride + 1:stride]
        got += torch.einsum('tchw,nc->tnhw', win, packed[tap])
    assert not got[:, cout:].any()
    assert norm_err(got[:, :cout].numpy(), want.numpy()) < TOL


# (n_in, Cin, Cout) of every conv over a concat the variants run on conv_cat
# (rconcat, conv_hr0; big and small widths), then the kernel tests' width.
CAT_SHAPES = [(3, 24, 24), (2, 24, 24), (3, 14, 14), (2, 14, 14),
              (3, 20, 13), (2, 20, 13)]


@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('n_in,cin,cout', CAT_SHAPES)
def test_packed_cat_taps_rebuild_the_concat_conv(n_in, cin, cout, itemsize):
    """conv_cat's weight panels (``cat_panel``, at the bfloat16 and the
    float32 panel widths): the conv rebuilt from them as a sum over taps of
    shifted matmuls, over the inputs each zero-padded to its chunk of
    columns and concatenated, equals ``conv_concat_plain`` with the weight
    rounded to the panel type; the padding rows and columns (between the
    inputs' channels too) are zero, a panel row is an odd number of 16-byte
    units, and the panels are packed once per weight."""
    dt = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    rng = np.random.default_rng(n_in * 100 + cin + cout)
    xs = [torch.from_numpy(rng.standard_normal((2, cin, 9, 13)).astype(
        np.float32)) for _ in range(n_in)]
    w = torch.from_numpy((rng.standard_normal((cout, n_in * cin, 3, 3))
                          / np.sqrt(9 * n_in * cin)).astype(np.float32))
    packed = chw.cat_panel(w, n_in, dt)
    assert chw.cat_panel(w, n_in, dt) is packed
    np_, kp = chw.cat_layout(n_in, cin, cout, itemsize)
    cp = chw.pad_chunk(cin, itemsize)
    assert np_ >= cout and kp >= n_in * cp and (kp * itemsize // 16) % 2 == 1
    assert packed.shape == (9, np_, kp) and packed.dtype == dt
    assert packed.is_contiguous()
    cols = torch.zeros(kp, dtype=torch.bool)
    for s in range(n_in):
        cols[s * cp:s * cp + cin] = True
    assert not packed[:, cout:].any() and not packed[:, :, ~cols].any()
    xp = torch.cat([F.pad(x, (1, 1, 1, 1, 0, cp - cin)) for x in xs], 1)
    xp = F.pad(xp, (0, 0, 0, 0, 0, kp - n_in * cp))
    got = torch.zeros(2, np_, 9, 13)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        got += torch.einsum('tchw,nc->tnhw', xp[:, :, ky:ky + 9, kx:kx + 13],
                            packed[tap].float())
    assert not got[:, cout:].any()
    want = chw.conv_concat_plain(xs, w.to(dt).float(), None, None)
    assert norm_err(got[:, :cout].numpy(), want.numpy()) < TOL


@pytest.mark.parametrize('n_in,cin,cout', CAT_SHAPES)
def test_conv_cat_tile_fits_shared_memory(n_in, cin, cout):
    """conv_cat's tile and whole panels fit a block's shared memory; in
    bfloat16 two blocks share an SM."""
    for itemsize in (2, 4):
        th, tw = chw.conv_cat_tile(n_in, cin, cout, itemsize)
        smem = chw.conv_cat_smem(n_in, cin, cout, itemsize, th, tw)
        assert smem <= chw.SMEM_BYTES
        if itemsize == 2:
            assert smem <= chw.TWO_PER_SM


@pytest.mark.parametrize('cin,cout,k,stride', CONV_SHAPES)
def test_conv_tile_fits_shared_memory(cin, cout, k, stride):
    for itemsize in (2, 4):
        th, tw = chw.conv_tile(cin, cout, k, stride, itemsize)
        assert chw.conv_smem(cin, cout, k, stride, th, tw,
                             itemsize) <= chw.SMEM_BYTES


# (Cin, Cout) of every SkipUpSample the variants run: 36->24, 48->36 and
# 80->80 (big), 18->14, 22->18 and 64->64 (small).
UP_SHAPES = [(36, 24), (48, 36), (80, 80), (18, 14), (22, 18), (64, 64)]


@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('cin,cout', UP_SHAPES)
def test_up_panel_unpacks_to_the_rounded_weight(cin, cout, itemsize):
    """up_skip's panel (csrc/up_skip.cu reads it as the B operand of its
    one-tap product): rows are output channels padded to whole n8 tiles,
    columns input channels, exactly the weight rounded to the activation
    type; the padding rows and columns are zero; the block's tile fits."""
    dt = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    rng = np.random.default_rng(cin + cout)
    w11 = torch.from_numpy(rng.standard_normal((cout, cin, 1, 1)).astype(
        np.float32))
    panel = chw.tap_panel(w11, dt)
    np_, kp = chw.mma_layout(cin, cout, itemsize)
    assert panel.shape == (1, np_, kp) and panel.dtype == dt
    assert np_ % 8 == 0 and np_ >= cout and (kp * itemsize // 16) % 2 == 1
    assert torch.equal(panel[0, :cout, :cin], w11[:, :, 0, 0].to(dt))
    assert not panel[:, cout:].any() and not panel[:, :, cin:].any()
    th, tw = chw.up_skip_tile(cin, cout, itemsize)
    smem = chw.up_skip_smem(cin, cout, itemsize, th, tw)
    assert smem <= chw.SMEM_BYTES and tw % 4 == 0
    if itemsize == 2:  # two blocks an SM
        assert smem <= chw.TWO_PER_SM


def test_up_panel_is_packed_once_per_weight():
    """The panel is kept with the weight: a second call returns it as it
    is, for another type a new one; writing the weight in place (as
    ``load_state_dict`` does) packs it anew."""
    mod = layers.SkipUpSample(24, 16)
    w = mod.up[1].weight
    first = chw.tap_panel(w, torch.bfloat16)
    assert chw.tap_panel(w, torch.bfloat16) is first
    f32 = chw.tap_panel(w, torch.float32)
    assert f32.dtype == torch.float32
    with torch.no_grad():
        w.mul_(2.0)
    again = chw.tap_panel(w, torch.float32)
    assert again is not f32
    assert torch.equal(again[0, :16, :24], w[:, :, 0, 0].detach())
    with torch.inference_mode():
        w_inf = torch.ones(16, 24, 1, 1)
    assert torch.equal(chw.tap_panel(w_inf, torch.float32)[0, :16, :24],
                       w_inf[:, :, 0, 0])


def test_up_skip_takes_the_float32_parameter():
    """The fused SkipUpSample hands up_skip its float32 parameter, rounded
    to the activation type inside: the same result as the weight cast by
    the caller, on the plain path here."""
    mod = layers.SkipUpSample(12, 8, fused=True)
    seeded(mod, 3)
    x = torch.from_numpy(rand((2, 12, 5, 7), 15)).to(torch.bfloat16)
    skip = torch.from_numpy(rand((2, 8, 10, 14), 16)).to(torch.bfloat16)
    w = mod.up[1].weight.detach()
    with torch.no_grad():
        got = mod(x, skip)
    assert torch.equal(got, chw.up_skip_plain(x, w.to(torch.bfloat16), skip))


@pytest.mark.parametrize('dtype,h,w,offset,route', [
    (torch.bfloat16, 16, 16, 0, 'vector'),   # 256 elements: 32 units
    (torch.bfloat16, 720, 1280, 0, 'vector'),  # the 720p plane
    (torch.float32, 2, 2, 0, 'vector'),      # one 16-byte unit
    (torch.bfloat16, 19, 37, 0, 'element'),  # the tests' ragged frames
    (torch.float32, 3, 3, 0, 'element'),     # 36 bytes a plane
    (torch.bfloat16, 16, 16, 1, 'element'),  # x 2 bytes off the grid
    (torch.float32, 2, 2, 2, 'element')])    # x 8 bytes off the grid
def test_cab_back_route(dtype, h, w, offset, route):
    """The 16-byte route where a plane is a whole number of 16-byte units
    and x, s and out are 16-byte aligned; element by element otherwise."""
    shape = (2, 3, h, w)
    n = 2 * 3 * h * w
    x = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    s = torch.zeros(shape, dtype=dtype)
    assert chw.cab_back_route(x, s, torch.empty_like(s)) == route
    if offset == 0:  # a misaligned s or out takes the element route too
        off = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
        assert chw.cab_back_route(x, off, s) == 'element'
        assert chw.cab_back_route(x, s, off) == 'element'


def test_tap_panel_is_packed_once_per_weight():
    """cab_front's and conv's panels are kept with the weight, as
    up_skip's is: a second call returns the panel as it is, another
    type a new one; writing the weight in place packs it anew."""
    mod = layers.Conv2d(12, 20, 3)
    seeded(mod, 5)
    w = mod.weight
    first = chw.tap_panel(w, torch.bfloat16)
    assert first.shape == (9, *chw.mma_layout(12, 20, 2))
    assert chw.tap_panel(w, torch.bfloat16) is first
    f32 = chw.tap_panel(w, torch.float32)
    assert f32 is not first and f32.dtype == torch.float32
    assert torch.equal(f32, chw.pack_taps(w.detach(),
                                          *chw.mma_layout(12, 20, 4)))
    with torch.no_grad():
        w.mul_(2.0)
    again = chw.tap_panel(w, torch.float32)
    assert again is not f32
    assert torch.equal(again[4, :20, :12], w[:, :, 1, 1].detach())


def test_cab_front_and_conv_take_the_float32_parameters():
    """``cab`` and the fused convs hand cab_front and conv their float32
    parameters, rounded to the activation type inside: the same result as
    the weights cast by the caller, on the plain path here."""
    x = torch.from_numpy(rand((2, 8, 5, 7), 17)).to(torch.bfloat16)
    w1, w2 = (torch.from_numpy(0.1 * rand((8, 8, 3, 3), 18 + i))
              for i in range(2))
    alpha = torch.tensor([0.25])
    got = chw.cab_front(x, w1, alpha, w2)
    want = chw.cab_front_plain(x, w1.bfloat16(), alpha, w2.bfloat16())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    b = torch.from_numpy(0.01 * rand((8,), 20))
    assert torch.equal(chw.conv(x, w1, b, None, 2),
                       chw.conv_plain(x, w1.bfloat16(), b, None, 2))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no_cuda'))
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.build()


def test_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'k.cu').write_text('// one\n')
    monkeypatch.setattr(_build, 'CSRC', src)
    first = _build.library_path()
    assert first == _build.library_path()
    (src / 'k.cu').write_text('// two\n')
    assert _build.library_path() != first
