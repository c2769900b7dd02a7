"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
The file imports no JAX, so it also runs on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are those
of ``chip_smoke.py``: normalized max error 1e-4 in float32 with TF32 off
(summation order only), 5e-2 in bfloat16 (single-ulp rounding flips on the
largest outputs).  ``shift_round`` and the copy probes only copy, so they
are held bit for bit; ``mm_loop`` sums in another order than its plain
version, so it may round one bf16 ulp apart at its largest output.
"""
import numpy as np
import pytest
import torch

from shiftnet_tpu_torch.models import init_state, layers
from shiftnet_tpu_torch.ops import chw, naf_chw, probes

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc: the kernels run only on '
                    'the card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def norm_err(a, b):
    d = (a.double() - b.double()).abs().max()
    return float(d / b.double().std())


def randn(g, *shape, scale=1.0):
    return scale * torch.randn(*shape, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c,h,w', [(24, 16, 16), (36, 19, 37), (48, 33, 20),
                                   (80, 21, 45),  # ragged edge tiles
                                   # the small variants' TFR widths, not
                                   # multiples of 8
                                   (14, 19, 37), (18, 33, 20), (22, 21, 45),
                                   # the small variants' Encoder2 width; rows
                                   # of 16-byte vectors (W % 8 == 0) and not
                                   (64, 37, 70), (64, 24, 48), (24, 35, 70),
                                   (80, 16, 40)])
def test_cab_front_and_back_match_plain(cuda, dtype, c, h, w):
    g = torch.Generator().manual_seed(c)
    x = randn(g, 3, c, h, w).to(cuda, dtype)
    w1 = randn(g, c, c, 3, 3, scale=(9 * c) ** -0.5).to(cuda, dtype)
    w2 = randn(g, c, c, 3, 3, scale=(9 * c) ** -0.5).to(cuda, dtype)
    alpha = torch.tensor([0.25], device=cuda)
    chw.reset_launches()
    s, sums = chw.cab_front(x, w1, alpha, w2)
    ps, psums = chw.cab_front_plain(x, w1, alpha, w2)
    assert norm_err(s, ps) < TOL[dtype]
    assert norm_err(sums, psums) < TOL[dtype]
    ca = torch.sigmoid(psums).to(dtype)
    want = chw.cab_back_plain(x, ps, ca)
    assert norm_err(chw.cab_back(x, ps, ca), want) < TOL[dtype]
    xc = x.clone()
    out = chw.cab_back(xc, ps, ca, inplace=True)
    assert out.data_ptr() == xc.data_ptr()
    assert norm_err(out, want) < TOL[dtype]
    assert chw.LAUNCHES['cab_front'] == 1 and chw.LAUNCHES['cab_back'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,stride', [(2, 2), (3, 1), (3, 2), (5, 1)])
@pytest.mark.parametrize('bias,prelu', [(False, False), (True, True)])
def test_conv_matches_plain(cuda, dtype, k, stride, bias, prelu):
    g = torch.Generator().manual_seed(10 * k + stride)
    cin, cout = 20, 13  # a partial output-channel group
    x = randn(g, 2, cin, 23, 34).to(cuda, dtype)
    wt = randn(g, cout, cin, k, k, scale=(k * k * cin) ** -0.5).to(cuda, dtype)
    b = randn(g, cout, scale=0.1).to(cuda) if bias else None
    a = torch.tensor([0.3], device=cuda) if prelu else None
    got = chw.conv(x, wt, b, a, stride)
    want = chw.conv_plain(x, wt, b, a, stride)
    assert got.shape == want.shape
    assert norm_err(got, want) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h,w', [(8, 16), (11, 29)])
def test_up_skip_matches_plain(cuda, dtype, h, w):
    g = torch.Generator().manual_seed(h)
    x = randn(g, 2, 48, h, w).to(cuda, dtype)
    w11 = randn(g, 36, 48, 1, 1, scale=48 ** -0.5).to(cuda, dtype)
    skip = randn(g, 2, 36, 2 * h, 2 * w).to(cuda, dtype)
    assert norm_err(chw.up_skip(x, w11, skip),
                    chw.up_skip_plain(x, w11, skip)) < TOL[dtype]


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 4, 4, device=cuda)
    w = torch.zeros(8, 8, 3, 3, device=cuda)
    alpha = torch.tensor([0.25], device=cuda)
    with pytest.raises(TypeError):
        chw.cab_front(x.half(), w.half(), alpha, w.half())
    with pytest.raises(ValueError, match='contiguous'):
        chw.cab_front(x.transpose(2, 3), w, alpha, w)
    with pytest.raises(TypeError):
        chw.conv(x, w, torch.zeros(8, device=cuda, dtype=torch.bfloat16),
                 None, 1)
    with pytest.raises(ValueError):
        chw.conv(x, torch.zeros(8, 8, 4, 4, device=cuda), None, None, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout,k,stride,bias,prelu', [
    (3, 24, 3, 1, True, False),    # feat_extract
    (24, 80, 2, 2, False, True),   # down01
    (80, 80, 3, 2, True, False),   # Encoder2 down12 / down23
    (80, 96, 3, 1, True, False),   # upsample_conv
    (48, 24, 3, 1, True, False),   # conv_hr0
    (72, 24, 3, 1, True, False),   # rconcat
    (14, 64, 2, 2, False, True),   # small variants: down01
    (64, 64, 3, 2, True, False),   # down12
    (64, 56, 3, 1, True, False),   # upsample_conv
    (14, 14, 3, 1, False, False),  # deblur_small's add-fuse conv_hr0
    (24, 36, 3, 2, True, False),   # TFR down12
    (36, 48, 3, 2, True, False),   # TFR down23
    (24, 24, 3, 1, False, True),   # conv_trans with its PReLU
    (24, 3, 5, 1, False, False),   # conv_last
])
def test_conv_encoder2_shapes_match_plain(cuda, dtype, cin, cout, k, stride,
                                          bias, prelu):
    g = torch.Generator().manual_seed(cin + cout)
    x = randn(g, 2, cin, 21, 38).to(cuda, dtype)
    wt = randn(g, cout, cin, k, k, scale=(k * k * cin) ** -0.5).to(cuda, dtype)
    b = randn(g, cout, scale=0.1).to(cuda) if bias else None
    a = torch.tensor([0.3], device=cuda) if prelu else None
    assert norm_err(chw.conv(x, wt, b, a, stride),
                    chw.conv_plain(x, wt, b, a, stride)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout,k', [(24, 36, 3), (36, 48, 3), (24, 80, 2),
                                        (14, 64, 2), (80, 80, 3), (20, 13, 5)])
@pytest.mark.parametrize('h,w', [(23, 35), (17, 9)])
def test_conv_stride2_odd_sizes_match_plain(cuda, dtype, cin, cout, k, h, w):
    g = torch.Generator().manual_seed(cin * h + k)
    x = randn(g, 2, cin, h, w).to(cuda, dtype)
    wt = randn(g, cout, cin, k, k, scale=(k * k * cin) ** -0.5).to(cuda, dtype)
    b = randn(g, cout, scale=0.1).to(cuda)
    got = chw.conv(x, wt, b, None, 2)
    want = chw.conv_plain(x, wt, b, None, 2)
    assert got.shape == want.shape
    assert norm_err(got, want) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [14, 24, 36, 48, 80])
def test_cab_front_every_tile_matches_plain(cuda, c, dt):
    """The kernel at each output tile that fits, not only the one
    ``cab_front_tile`` picks."""
    g = torch.Generator().manual_seed(c + 1)
    x = randn(g, 2, c, 37, 70).to(cuda, dt)
    w1 = randn(g, c, c, 3, 3, scale=(9 * c) ** -0.5).to(cuda, dt)
    w2 = randn(g, c, c, 3, 3, scale=(9 * c) ** -0.5).to(cuda, dt)
    alpha = torch.tensor([0.25], device=cuda)
    ps, psums = chw.cab_front_plain(x, w1, alpha, w2)
    tiles = [t for t in chw.CAB_TILES
             if chw.cab_front_smem(c, x.element_size(), *t)
             <= chw.SMEM_BYTES]
    assert tiles
    for tile in tiles:
        s, sums = chw.cab_front(x, w1, alpha, w2, tile=tile)
        assert norm_err(s, ps) < TOL[dt], tile
        assert norm_err(sums, psums) < TOL[dt], tile


@pytest.mark.cuda
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout,k,stride', [(80, 96, 3, 1), (24, 36, 3, 2),
                                               (72, 24, 3, 1)])
def test_conv_every_tile_matches_plain(cuda, cin, cout, k, stride, dt):
    g = torch.Generator().manual_seed(cin + cout)
    x = randn(g, 2, cin, 37, 70).to(cuda, dt)
    wt = randn(g, cout, cin, k, k, scale=(k * k * cin) ** -0.5).to(cuda, dt)
    b = randn(g, cout, scale=0.1).to(cuda)
    want = chw.conv_plain(x, wt, b, None, stride)
    for tile in chw.CONV_TILES:
        if chw.conv_smem(cin, cout, k, stride, *tile,
                         x.element_size()) <= chw.SMEM_BYTES:
            got = chw.conv(x, wt, b, None, stride, tile=tile)
            assert norm_err(got, want) < TOL[dt], tile


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cab_front_and_conv_are_deterministic(cuda, dtype):
    """Two launches on the same input give the same bits: every sum is
    taken in one fixed order, with no atomics."""
    g = torch.Generator().manual_seed(7)
    c = 48
    x = randn(g, 3, c, 37, 70).to(cuda, dtype)
    w1 = randn(g, c, c, 3, 3, scale=(9 * c) ** -0.5).to(cuda, dtype)
    w2 = randn(g, c, c, 3, 3, scale=(9 * c) ** -0.5).to(cuda, dtype)
    alpha = torch.tensor([0.25], device=cuda)
    s1, sums1 = chw.cab_front(x, w1, alpha, w2)
    s2, sums2 = chw.cab_front(x, w1, alpha, w2)
    assert torch.equal(s1, s2) and torch.equal(sums1, sums2)
    b = randn(g, c, scale=0.1).to(cuda)
    assert torch.equal(chw.conv(x, w1, b, alpha, 1),
                       chw.conv(x, w1, b, alpha, 1))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_conv_with_four_input_channels_matches_plain(cuda, dtype):
    """denoise feat_extract: RGB + noise map, a partial 8-channel chunk
    that the kernel pads with zeros."""
    g = torch.Generator().manual_seed(4)
    x = randn(g, 3, 4, 19, 37).to(cuda, dtype)
    wt = randn(g, 24, 4, 3, 3, scale=36 ** -0.5).to(cuda, dtype)
    b = randn(g, 24, scale=0.1).to(cuda)
    assert norm_err(chw.conv(x, wt, b, None, 1),
                    chw.conv_plain(x, wt, b, None, 1)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n_in,bias,prelu', [(2, True, False),
                                             (3, True, False),
                                             (3, False, True)])
@pytest.mark.parametrize('h,w', [(19, 37), (33, 20)])  # ragged edge tiles
@pytest.mark.parametrize('cin,cout', [(20, 13), (24, 24), (14, 14)])
def test_conv_cat_matches_plain(cuda, dtype, n_in, bias, prelu, h, w, cin,
                                cout):
    """rconcat (3 inputs, bias or PReLU) and conv_hr0 (2 inputs, bias) at
    the big (24) and small (14) widths; Cin = 20 leaves a partial 8-channel
    chunk in each input, 14 one in bfloat16 and a padded one in float32.
    The float32 parameter, rounded inside, gives the same bits as the
    weight rounded by the caller."""
    g = torch.Generator().manual_seed(n_in * h + cin)
    xs = [randn(g, 2, cin, h, w).to(cuda, dtype) for _ in range(n_in)]
    w32 = randn(g, cout, n_in * cin, 3, 3,
                scale=(9 * cin * n_in) ** -0.5).to(cuda)
    wt = w32.to(dtype)
    b = randn(g, cout, scale=0.1).to(cuda) if bias else None
    a = torch.tensor([0.3], device=cuda) if prelu else None
    chw.reset_launches()
    got = chw.conv_concat(xs, wt, b, a)
    assert chw.LAUNCHES['conv_cat'] == 1
    want = chw.conv_concat_plain(xs, wt, b, a)
    assert got.shape == (2, cout, h, w) and got.dtype == dtype
    assert norm_err(got, want) < TOL[dtype]
    assert torch.equal(chw.conv_concat(xs, w32, b, a), got)
    if dtype == torch.float32:  # and the conv over the concat
        cat = chw.conv_plain(torch.cat(xs, 1), wt, b, a, 1)
        assert norm_err(got, cat) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('tile', chw.CONV_TILES)
def test_conv_cat_every_tile_matches_plain(cuda, dtype, tile):
    g = torch.Generator().manual_seed(tile[0] + tile[1])
    xs = [randn(g, 2, 24, 21, 45).to(cuda, dtype) for _ in range(3)]
    wt = randn(g, 24, 72, 3, 3, scale=(9 * 72) ** -0.5).to(cuda, dtype)
    b = randn(g, 24, scale=0.1).to(cuda)
    assert norm_err(chw.conv_concat(xs, wt, b, None, tile=tile),
                    chw.conv_concat_plain(xs, wt, b, None)) < TOL[dtype]


@pytest.mark.cuda
def test_conv_cat_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 6, 6, device=cuda)
    w = torch.zeros(8, 16, 3, 3, device=cuda)
    with pytest.raises(ValueError):  # K = 5
        chw.conv_concat([x, x], torch.zeros(8, 16, 5, 5, device=cuda),
                        None, None)
    with pytest.raises(ValueError):  # mismatched input shapes
        chw.conv_concat([x, x[:, :, :4]], w, None, None)
    with pytest.raises(ValueError):  # float16
        chw.conv_concat([x.half(), x.half()], w.half(), None, None)
    with pytest.raises(ValueError):  # one input
        chw.conv_concat([x], w[:, :8].contiguous(), None, None)
    with pytest.raises(ValueError):  # a weight that is not over the concat
        chw.conv_concat([x, x], w[:, :8].contiguous(), None, None)
    with pytest.raises(ValueError):  # a bias that is not one per Cout
        chw.conv_concat([x, x], w, torch.zeros(4, device=cuda), None)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_up_skip_at_encoder2_width_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(80)
    x = randn(g, 2, 80, 11, 20).to(cuda, dtype)
    w11 = randn(g, 80, 80, 1, 1, scale=80 ** -0.5).to(cuda, dtype)
    skip = randn(g, 2, 80, 22, 40).to(cuda, dtype)
    assert norm_err(chw.up_skip(x, w11, skip),
                    chw.up_skip_plain(x, w11, skip)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout', [(18, 14), (22, 18), (64, 64)])
def test_up_skip_at_small_widths_matches_plain(cuda, dtype, cin, cout):
    """The small variants' TFR up32 / up21 and Encoder2's up21."""
    g = torch.Generator().manual_seed(cin)
    x = randn(g, 2, cin, 11, 19).to(cuda, dtype)
    w11 = randn(g, cout, cin, 1, 1, scale=cin ** -0.5).to(cuda, dtype)
    skip = randn(g, 2, cout, 22, 38).to(cuda, dtype)
    assert norm_err(chw.up_skip(x, w11, skip),
                    chw.up_skip_plain(x, w11, skip)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('number', [3, 4, 5])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('patch', [False, True])
# rows of whole 16-byte units in both types (W % 8 == 0; 1040: more than
# one pass of a warp over a row), in float32 only (36), and in neither
@pytest.mark.parametrize('h,w', [(19, 37), (18, 40), (13, 36), (12, 1040)])
def test_shift_round_matches_plain_bit_for_bit(cuda, dtype, number, reverse,
                                               patch, h, w):
    g = torch.Generator().manual_seed(number)
    x = randn(g, 3, 16 * number, h, w).to(cuda, dtype)
    kw = dict(reverse=reverse, boundary_patch=patch)
    chw.reset_launches()
    y, hw = naf_chw.shift_round(x, number, **kw)
    py, phw = naf_chw.shift_round_plain(x, number, **kw)
    assert torch.equal(y, py) and torch.equal(hw, phw)
    assert chw.LAUNCHES['shift_round'] == 1


def naf_params(n, cab2, opts, device, seed, depthwise=False):
    """Torch-named parameters of a CAB2 / CAB1 with a LayerNorm that is not
    the identity (c2 != 0, so the halo masks matter), beta of order 1 and,
    with ``opts``, the mid-CALayer and a nonzero last bias; ``depthwise``
    gives the small variants' depthwise RepConv."""
    kw = dict(kernel_size=5, reduction=4, mid_ca=opts, last_bias=opts,
              repconv_depthwise=depthwise)
    mod = (layers.CAB2(n, 8 * (n // 16), **kw) if cab2
           else layers.CAB1(n, **kw))
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
    return {k: v.detach().to(device) for k, v in mod.named_parameters()}


def check_naf_kernels(cuda, dtype, n, cab2, opts, h, w, depthwise=False):
    """Each of naf_gate, naf_rep and naf_back against its plain version on
    the plain version's inputs, then the whole block."""
    p = naf_params(n, cab2, opts, cuda, seed=n + h, depthwise=depthwise)
    prep = naf_chw.prep_naf(p, '', dtype, mid_ca=opts, last_bias=opts)
    assert prep['rep'].shape == (n, 1 if depthwise else 8, 5, 5)
    g = torch.Generator().manual_seed(n * h)
    y = randn(g, 3, n, h, w).to(cuda, dtype)
    hw = randn(g, 3, 8 * (n // 16), h, w).to(cuda, dtype) if cab2 else None
    tol = TOL[dtype]
    chw.reset_launches()
    got, gsums = naf_chw.naf_gate(y, hw, prep)
    pg, pgsums = naf_chw.naf_gate_plain(y, hw, prep)
    assert norm_err(got, pg) < tol and norm_err(gsums, pgsums) < tol
    cag = torch.sigmoid(pgsums / (h * w)).to(dtype) if opts else None
    s, sums = naf_chw.naf_rep(pg, cag, prep)
    ps, psums = naf_chw.naf_rep_plain(pg, cag, prep)
    assert norm_err(s, ps) < tol and norm_err(sums, psums) < tol
    ca = torch.sigmoid(psums / (h * w)).to(dtype)
    want = naf_chw.naf_back_plain(y, ps, ca, prep)
    assert norm_err(naf_chw.naf_back(y, ps, ca, prep), want) < tol
    yc = y.clone()
    out = naf_chw.naf_back(yc, ps, ca, prep, inplace=True)
    assert out.data_ptr() == yc.data_ptr() and norm_err(out, want) < tol
    assert [chw.LAUNCHES[k] for k in ('naf_gate', 'naf_rep', 'naf_back')] \
        == [1, 1, 2]
    if dtype == torch.float32:  # the block, kernels against the CPU chain
        full = naf_chw.naf_cab(p, '', y, hw, mid_ca=opts, last_bias=opts)
        cpu = {k: v.cpu() for k, v in p.items()}
        ref = naf_chw.naf_cab(cpu, '', y.cpu(), None if hw is None
                              else hw.cpu(), mid_ca=opts, last_bias=opts)
        assert norm_err(full.cpu(), ref) < tol


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,cab2,opts', [
    (48, True, False), (80, True, False), (80, False, False),
    (48, False, True), (80, True, True)])  # opts: cag, b7
@pytest.mark.parametrize('h,w', [(19, 37), (33, 20)])  # ragged edge tiles
def test_naf_kernels_match_plain(cuda, dtype, n, cab2, opts, h, w):
    check_naf_kernels(cuda, dtype, n, cab2, opts, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cab2,opts', [(True, False), (False, False),
                                       (True, True), (False, True)])
@pytest.mark.parametrize('h,w', [(19, 37), (33, 20)])  # ragged edge tiles
def test_naf_kernels_depthwise_match_plain(cuda, dtype, cab2, opts, h, w):
    """The small variants' blocks: n = 64, add_c 32, the depthwise RepConv
    (naf_rep's G = 1 form); opts: deblur_small has neither cag nor b7,
    denoise_small both."""
    check_naf_kernels(cuda, dtype, 64, cab2, opts, h, w, depthwise=True)


def naf_inputs(cuda, dtype, n, cab2, depthwise, h, w, seed):
    p = naf_params(n, cab2, True, cuda, seed=seed, depthwise=depthwise)
    prep = naf_chw.prep_naf(p, '', dtype, mid_ca=True, last_bias=True)
    g = torch.Generator().manual_seed(seed)
    y = randn(g, 2, n, h, w).to(cuda, dtype)
    hw = (randn(g, 2, n // 2, h, w).to(cuda, dtype) if cab2 else None)
    cag = torch.rand(2, n, generator=g).to(cuda, dtype)
    return prep, y, hw, cag


@pytest.mark.cuda
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,cab2,depthwise', [
    (80, True, False), (80, False, False), (64, True, True),
    (64, False, True), (48, True, False)])
# ragged frames; at W = 72 the rows are whole 16-byte chunks, so the
# tiles go out in 16-byte stores
@pytest.mark.parametrize('h,w', [(37, 70), (21, 72)])
def test_naf_gate_and_rep_every_tile_match_plain(cuda, n, cab2, depthwise,
                                                 h, w, dt):
    """The tensor-core naf_gate (CAB2 and CAB1) and naf_rep (grouped and
    depthwise, with cag) at each output tile that fits, not only the
    picked one."""
    prep, y, hw, cag = naf_inputs(cuda, dt, n, cab2, depthwise, h, w,
                                  seed=n + cab2)
    size = y.element_size()
    pg, pgsums = naf_chw.naf_gate_plain(y, hw, prep)
    ps, psums = naf_chw.naf_rep_plain(pg, cag, prep)
    add_c = 0 if hw is None else hw.shape[1]
    group = 1 if depthwise else 8
    gate_tiles = [t for t in naf_chw.TILES if naf_chw.naf_gate_smem(
        n, add_c, size, *t) <= chw.SMEM_BYTES]
    rep_tiles = [t for t in naf_chw.TILES if naf_chw.naf_rep_smem(
        n, size, *t, group) <= chw.SMEM_BYTES]
    assert gate_tiles and rep_tiles
    for tile in gate_tiles:
        got, gsums = naf_chw.naf_gate(y, hw, prep, tile=tile)
        assert norm_err(got, pg) < TOL[dt], tile
        assert norm_err(gsums, pgsums) < TOL[dt], tile
    for tile in rep_tiles:
        s, sums = naf_chw.naf_rep(pg, cag, prep, tile=tile)
        assert norm_err(s, ps) < TOL[dt], tile
        assert norm_err(sums, psums) < TOL[dt], tile


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,depthwise', [(80, False), (64, True)])
def test_naf_gate_and_rep_are_deterministic(cuda, dtype, n, depthwise):
    """Two launches on the same input give the same bits: every sum is
    taken in one fixed order, with no atomics."""
    prep, y, hw, cag = naf_inputs(cuda, dtype, n, True, depthwise, 29, 45,
                                  seed=3)
    g1, gs1 = naf_chw.naf_gate(y, hw, prep)
    g2, gs2 = naf_chw.naf_gate(y, hw, prep)
    assert torch.equal(g1, g2) and torch.equal(gs1, gs2)
    s1, ss1 = naf_chw.naf_rep(g1, cag, prep)
    s2, ss2 = naf_chw.naf_rep(g1, cag, prep)
    assert torch.equal(s1, s2) and torch.equal(ss1, ss2)


def back_inputs(cuda, dtype, n, b7, h, w, seed):
    """naf_back's inputs: a CAB1's prep (with ``b7``, the denoise variants'
    biased projection), y, s and a CALayer scale ca in (0, 1)."""
    p = naf_params(n, False, b7, cuda, seed=seed)
    prep = naf_chw.prep_naf(p, '', dtype, mid_ca=b7, last_bias=b7)
    g = torch.Generator().manual_seed(seed)
    y = randn(g, 3, n, h, w).to(cuda, dtype)
    s = randn(g, 3, n, h, w).to(cuda, dtype)
    ca = torch.rand(3, n, generator=g).to(cuda, dtype)
    return prep, y, s, ca


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,b7', [(48, True), (64, True), (64, False),
                                  (80, False), (80, True)])
# 24 x 20: whole 16-byte chunks (cp.async) and a ragged last tile; 19 x 37:
# a plane off the 16-byte grid (element loads)
@pytest.mark.parametrize('h,w', [(24, 20), (19, 37)])
def test_naf_back_ragged_planes_match_plain(cuda, dtype, n, b7, h, w):
    """The tensor-core naf_back on planes that are not a multiple of its
    128-pixel tile; in place over y it gives the fresh output's bits."""
    prep, y, s, ca = back_inputs(cuda, dtype, n, b7, h, w, seed=n + h)
    want = naf_chw.naf_back_plain(y, s, ca, prep)
    assert (h * w) % naf_chw.BACK_PX
    chw.reset_launches()
    got = naf_chw.naf_back(y, s, ca, prep)
    assert norm_err(got, want) < TOL[dtype]
    yc = y.clone()
    out = naf_chw.naf_back(yc, s, ca, prep, inplace=True)
    assert out.data_ptr() == yc.data_ptr() and torch.equal(out, got)
    assert chw.LAUNCHES['naf_back'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout', [(36, 24), (48, 36), (80, 80),
                                      (18, 14), (22, 18), (64, 64)])
# odd sizes (element blend items), then 2w = 80: 16-byte rows
@pytest.mark.parametrize('h,w', [(13, 21), (9, 40)])
def test_up_skip_every_tile_matches_plain(cuda, dtype, cin, cout, h, w):
    """The tensor-core up_skip at every SkipUpSample width, each tile that
    fits; Cout = 14 and 18 leave padded n8 columns.  The float32 parameter,
    rounded inside, gives the bits of the weight cast by the caller."""
    g = torch.Generator().manual_seed(cin * h + cout)
    x = randn(g, 2, cin, h, w).to(cuda, dtype)
    w32 = randn(g, cout, cin, 1, 1, scale=cin ** -0.5).to(cuda)
    w11 = w32.to(dtype)
    skip = randn(g, 2, cout, 2 * h, 2 * w).to(cuda, dtype)
    want = chw.up_skip_plain(x, w11, skip)
    size = x.element_size()
    tiles = [t for t in chw.UP_TILES
             if chw.up_skip_smem(cin, cout, size, *t) <= chw.SMEM_BYTES]
    assert tiles and chw.up_skip_tile(cin, cout, size) in tiles
    for tile in tiles:
        got = chw.up_skip(x, w11, skip, tile=tile)
        assert norm_err(got, want) < TOL[dtype], tile
    assert torch.equal(chw.up_skip(x, w32, skip), chw.up_skip(x, w11, skip))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_naf_back_and_up_skip_are_deterministic(cuda, dtype):
    """Two launches on the same input give the same bits."""
    prep, y, s, ca = back_inputs(cuda, dtype, 80, True, 29, 48, seed=5)
    assert torch.equal(naf_chw.naf_back(y, s, ca, prep),
                       naf_chw.naf_back(y, s, ca, prep))
    g = torch.Generator().manual_seed(6)
    x = randn(g, 3, 80, 23, 40).to(cuda, dtype)
    w11 = randn(g, 80, 80, 1, 1, scale=80 ** -0.5).to(cuda, dtype)
    skip = randn(g, 3, 80, 46, 80).to(cuda, dtype)
    assert torch.equal(chw.up_skip(x, w11, skip), chw.up_skip(x, w11, skip))


@pytest.mark.cuda
def test_naf_kernels_reject_what_they_do_not_take(cuda):
    p = naf_params(48, True, False, cuda, seed=0)
    prep = naf_chw.prep_naf(p, '', torch.float32)
    y = torch.zeros(2, 48, 8, 8, device=cuda)
    with pytest.raises(ValueError):  # CAB2 weights without hw
        naf_chw.naf_gate(y, None, prep)
    with pytest.raises(TypeError):
        naf_chw.naf_rep(y.half(), None, prep)
    with pytest.raises(ValueError):
        naf_chw.shift_round(y, 7, reverse=False, boundary_patch=True)


def bf16_randn(g, *shape, device):
    return randn(g, *shape).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', [
    (40, 216, 24),    # N = 24, K = 216: three n8 tiles a warp, K padded
    (24, 216, 200),   # M = 24: one partial 32-row warp tile
    (300, 80, 160),   # the Encoder2 expand's K and N
    (70, 40, 16),     # K filled with zeros to a 64-deep chunk, N to 24
    (130, 512, 8)])   # N = 8 in a 24-wide tile, a 512-deep panel
def test_mm_loop_matches_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.rand(m, k, generator=g).to(cuda, torch.bfloat16)
    b = torch.rand(k, n, generator=g).to(cuda, torch.bfloat16)
    probes.reset_launches()
    got = probes.mm_loop(a, b, 3)
    want = probes.mm_loop_plain(a, b, 3)
    assert got.shape == (m, n) and probes.LAUNCHES['mm_loop'] == 1
    err = (got.double() - want.double()).abs().max()
    assert err <= 2.0 ** -7 * want.double().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('bm', [64, 128])
@pytest.mark.parametrize('bn', probes.MM_WIDTHS)
def test_mm_loop_every_tile_matches_plain(cuda, bm, bn):
    """Every tile the kernel instantiates, on a product ragged in M, K and
    N: 64-column boxes read in part (BN 24, 32, 96, 160), a last column
    tile whose boxes past N are not loaded, K = 216 in a part-full chunk."""
    m, k, n = 200, 216, 200
    g = torch.Generator().manual_seed(bm + bn)
    a = torch.rand(m, k, generator=g).to(cuda, torch.bfloat16)
    b = torch.rand(k, n, generator=g).to(cuda, torch.bfloat16)
    got = probes.mm_loop(a, b, 2, plan=probes.mm_tile(bm, bn, m, k, n))
    want = probes.mm_loop_plain(a, b, 2)
    err = (got.double() - want.double()).abs().max()
    assert err <= 2.0 ** -7 * want.double().abs().max()


@pytest.mark.cuda
def test_mm_loop_refuses_unaligned_rows(cuda):
    """K or N not a multiple of 8 has no tensor map: the wrapper raises."""
    a = torch.zeros(70, 30, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(30, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='multiples of 8'):
        probes.mm_loop(a, b, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('staged', [False, True])
@pytest.mark.parametrize('case', ['hbm', 'shift', 'slab', 'offset',
                                  'part_rows', 'unaligned_src',
                                  'unaligned_both'])
def test_block_copies_match_plain(cuda, staged, case):
    g = torch.Generator().manual_seed(7)
    src_lane = 0
    if case == 'hbm':        # tools/probe_hbm_copy.py at a small size
        x = bf16_randn(g, 4, 64, 136, device=cuda)
        pieces, lanes = probes.hbm_copy_pieces(4, 40, 9), 136
        out_shape = x.shape
    elif case == 'shift':    # the half-channel permutation, pp 2, cb 16
        x = bf16_randn(g, 3, 32, 1000, device=cuda)
        out_shape, pieces = x.shape, probes.shift_pieces(3, 2, 16, 8)
        lanes = 1000
    elif case == 'slab':     # 32-row slabs of frame 0
        x = bf16_randn(g, 2, 96, 24 * 40, device=cuda)
        out_shape, pieces = (1, 96, 960), probes.slab_pieces(96, 32)
        lanes = 960
    elif case == 'offset':   # rows 8 .. 48 of a (128, 1024) slab
        x = bf16_randn(g, 1, 128, 1024, device=cuda)
        out_shape, pieces, lanes = (1, 40, 1024), [(0, 8, 0, 0, 40)], 1024
    elif case == 'part_rows':  # 512 of 1024 lanes into 520-lane rows
        x = bf16_randn(g, 2, 48, 1024, device=cuda)
        out_shape, lanes = (2, 40, 520), 512
        pieces = [(1, 8, 0, 0, 40), (0, 3, 1, 2, 30)]
    elif case == 'unaligned_src':  # a 6-byte source offset on every row
        x = bf16_randn(g, 1, 128, 1024, device=cuda)
        out_shape, pieces, lanes = (1, 48, 1016), [(0, 40, 0, 0, 48)], 1016
        src_lane = 3
    else:  # an odd source offset, odd rows on both sides: a destination
        # row starts off the 16-byte grid too
        x = bf16_randn(g, 2, 20, 333, device=cuda)
        out_shape, pieces = (2, 25, 341), [(1, 3, 0, 5, 11), (0, 0, 1, 1, 20)]
        lanes, src_lane = 317, 5
    probes.reset_launches()
    kw = dict(src_lane=src_lane)
    if staged:
        # a ragged last tile, a slot of whole rows or of row segments, and
        # a scale on the way out
        got = probes.block_copy_staged(x, out_shape, pieces, lanes,
                                       tile=max(8, lanes // 3 + 5), scale=2.0,
                                       **kw)
        want = probes.block_copy_plain(x.cpu(), out_shape, pieces, lanes,
                                       scale=2.0, **kw)
    else:
        got = probes.block_copy(x, out_shape, pieces, lanes, **kw)
        want = probes.block_copy_plain(x.cpu(), out_shape, pieces, lanes,
                                       **kw)
    assert torch.equal(probes.written(got.cpu(), pieces, lanes),
                       probes.written(want, pieces, lanes))
    name = 'block_copy_staged' if staged else 'block_copy'
    assert probes.LAUNCHES[name] == 1
    if staged:  # the TMA takes a source lane off the 16-byte grid
        want_route = 'cp.async' if case == 'unaligned_both' else 'tma'
    else:
        want_route = 'element' if case.startswith('unaligned') else 'vector'
    assert probes.ROUTES[name] == want_route


@pytest.mark.cuda
def test_block_copy_staged_wide_tile(cuda):
    """A tile wider than a slot goes through in row segments."""
    g = torch.Generator().manual_seed(8)
    x = bf16_randn(g, 2, 6, 20011, device=cuda)
    pieces = probes.shift_pieces(2, 1, 6, 3)
    got = probes.block_copy_staged(x, x.shape, pieces, 20003, src_lane=3)
    want = probes.block_copy_plain(x.cpu(), x.shape, pieces, 20003, 3)
    assert torch.equal(probes.written(got.cpu(), pieces, 20003),
                       probes.written(want, pieces, 20003))


# Staged copies on the TMA route: each probe tool's copy at its full shape
# (x shape, out shape, pieces, lanes, src_lane, scale); then boxes ragged in
# rows (293 > 256) and lanes (997, not 8-aligned, under the output's 1000)
# beside other pieces of the output; then more runs (12 piece heights) than
# the kernel parameter holds, so the maps go through device memory.
TMA_COPIES = {
    'copy_x2': ((16, 384, 30720), (1, 384, 30720),
                probes.slab_pieces(384, 32), 30720, 0, 2.0),
    'permute_jax_8_tiles': ((12, 320, 72320), (12, 320, 72320),
                            probes.shift_pieces(12, 4, 80, 40), 71680, 0,
                            1.0),
    'permute_jax_16_tiles': ((12, 320, 72320), (12, 320, 72320),
                             probes.shift_pieces(12, 4, 80, 40), 72192, 0,
                             1.0),
    'permute_port_t4': ((4, 80, 230400), (4, 80, 230400),
                        probes.shift_pieces(4, 1, 80, 40), 230400, 0, 1.0),
    'permute_port_t40': ((40, 80, 230400), (40, 80, 230400),
                         probes.shift_pieces(40, 1, 80, 40), 230400, 0,
                         1.0),
    'dma_offset_40': ((1, 128, 1024), (1, 48, 1024), [(0, 40, 0, 0, 48)],
                      1024, 0, 1.0),
    'dma_offset_8': ((1, 128, 1024), (1, 48, 1024), [(0, 8, 0, 0, 48)],
                     1024, 0, 1.0),
    'dma_lane_3': ((1, 128, 1024), (1, 48, 1016), [(0, 40, 0, 0, 48)],
                   1016, 3, 1.0),
    'ragged_boxes': ((2, 300, 1000), (3, 310, 1000),
                     [(0, 1, 1, 3, 293), (1, 5, 2, 0, 293),
                      (1, 0, 0, 300, 9)], 997, 2, 2.0),
    'many_runs': ((1, 200, 64), (1, 200, 64),
                  [(0, 15 * i, 0, 16 * i, 3 + i) for i in range(12)], 56, 8,
                  1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(TMA_COPIES))
def test_tma_copy_matches_plain(cuda, case):
    x_shape, out_shape, pieces, lanes, src_lane, scale = TMA_COPIES[case]
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    assert probes.staged_route(x, out_shape) == 'tma'
    probes.reset_launches()
    got = probes.block_copy_staged(x, out_shape, pieces, lanes,
                                   src_lane=src_lane, scale=scale)
    want = probes.block_copy_plain(x, out_shape, pieces, lanes, src_lane,
                                   scale)
    assert torch.equal(probes.written(got, pieces, lanes),
                       probes.written(want, pieces, lanes))
    assert probes.LAUNCHES['block_copy_staged'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fused_cab_and_conv_keep_their_panels(cuda, dtype):
    """The fused CAB and conv hand the kernels their float32 parameters:
    each weight's panels are packed at the first call and reused at the
    next, and the result is the kernels' on the weights cast by the
    caller."""
    cab = layers.CAB(24, fused=True)
    conv = layers.Conv2d(24, 36, 3, stride=2, fused=True)
    for mod, seed in ((cab, 3), (conv, 4)):
        mod.load_state_dict(init_state(mod, seed), strict=True)
        mod.to(cuda)
    g = torch.Generator().manual_seed(5)
    x = randn(g, 2, 24, 20, 36).to(cuda, dtype)
    w1, w2 = cab.body[0].weight, cab.body[2].weight
    with torch.no_grad():
        got, down = cab(x), conv(x)
        panels = [w._tap_panel[1] for w in (w1, w2, conv.weight)]
        assert torch.equal(cab(x), got) and torch.equal(conv(x), down)
        assert all(w._tap_panel[1] is p
                   for w, p in zip((w1, w2, conv.weight), panels))
        s, sums = chw.cab_front(x, w1.to(dtype), cab.body[1].weight,
                                w2.to(dtype))
        ca = chw.ca_mlp(sums, 20 * 36, cab.CA.conv_du[0].weight,
                        cab.CA.conv_du[2].weight, dtype)
        assert torch.equal(got, chw.cab_back(x, s, ca))
        assert torch.equal(down, chw.conv(x, conv.weight.to(dtype), None,
                                          None, 2))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c,h,w,offset', [
    (24, 90, 160, 0), (80, 16, 40, 0), (24, 16, 16, 0),  # 16-byte units
    (24, 19, 37, 0), (14, 33, 20, 0), (22, 21, 45, 0),   # ragged planes
    (24, 16, 16, 1)])                                    # x off the grid
def test_cab_back_matches_plain_bit_for_bit(cuda, dtype, c, h, w, offset):
    g = torch.Generator().manual_seed(c + h)
    shape = (3, c, h, w)
    n = 3 * c * h * w
    x = randn(g, n + offset).to(cuda, dtype)[offset:].view(shape)
    s = randn(g, *shape).to(cuda, dtype)
    ca = torch.rand(3, c, generator=g).to(cuda, dtype)
    unit = 16 // x.element_size()
    vector = h * w % unit == 0 and offset == 0
    assert chw.cab_back_route(x, s, x) == ('vector' if vector else 'element')
    want = chw.cab_back_plain(x, s, ca)
    chw.reset_launches()
    assert torch.equal(chw.cab_back(x, s, ca), want)
    xc = x.clone()
    out = chw.cab_back(xc, s, ca, inplace=True)
    assert out.data_ptr() == xc.data_ptr() and torch.equal(out, want)
    assert chw.LAUNCHES['cab_back'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['lane', 'block', 'store'])
@pytest.mark.parametrize('rows,m', [(24, 2560), (5, 512)])
def test_strided_copy_matches_plain(cuda, mode, rows, m):
    g = torch.Generator().manual_seed(rows + m)
    x = bf16_randn(g, rows, m, device=cuda)
    probes.reset_launches()
    got = probes.strided_copy(x, mode)
    assert torch.equal(got.cpu(), probes.strided_copy_plain(x.cpu(), mode))
    assert probes.LAUNCHES['strided_copy'] == 1


@pytest.mark.cuda
def test_probes_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        probes.mm_loop(x[0].float(), x[0].float().t(), 1)
    with pytest.raises(ValueError):  # rows past the source
        probes.block_copy(x, x.shape, [(0, 4, 0, 0, 5)], 64)
    with pytest.raises(ValueError):
        probes.block_copy(x, x.shape, [(0, 0, 0, 0, 1)] * 129, 64)
    with pytest.raises(ValueError):  # lanes not a multiple of 16
        probes.strided_copy(x[0, :, :40].contiguous(), 'lane')
