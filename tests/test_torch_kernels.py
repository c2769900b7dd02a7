"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
The file imports no JAX, so it also runs on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are those
of ``chip_smoke.py``: normalized max error 1e-4 in float32 with TF32 off
(summation order only), 5e-2 in bfloat16 (single-ulp rounding flips on the
largest outputs).
"""
import pytest
import torch

from shiftnet_tpu_torch.ops import chw

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
                                   (80, 21, 45)])  # ragged edge tiles
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
