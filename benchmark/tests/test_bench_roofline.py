"""The kernels' operation counts against ``FlopCounterMode`` on the
matching reference modules, and the peaks."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import roofline
from benchmark.reference import model as ref


def counted(fn, *args) -> int:
    c = FlopCounterMode(display=False)
    with c, torch.no_grad():
        fn(*args)
    return c.get_total_flops()


def test_peaks():
    assert roofline.PEAK_FLOPS[torch.bfloat16] == 989e12
    assert roofline.PEAK_FLOPS[torch.float32] == 495e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize('c,h,w', [(24, 36, 64), (80, 18, 32)])
def test_cab_front_ops(c, h, w):
    x = torch.empty(2, c, h, w, device='meta')
    body = ref.CAB(c, 4).to('meta').body
    ops, _ = roofline.cab_front(x, body[0].weight, body[1].weight,
                                body[2].weight)
    assert ops == counted(body, x)


@pytest.mark.parametrize('cin,cout,k,stride', [
    (24, 36, 3, 2), (3, 24, 3, 1), (24, 3, 5, 1), (24, 80, 2, 2),
    (80, 96, 3, 1)])
def test_conv_ops(cin, cout, k, stride):
    x = torch.empty(2, cin, 20, 36, device='meta')
    pad = k // 2 if stride == 1 else (1 if k == 3 else 0)
    conv = ref.Conv2d(cin, cout, k, stride=stride, padding=pad).to('meta')
    ops, nb = roofline.conv(x, conv.weight, None, None, stride)
    assert ops == counted(conv, x)
    out = conv(x)
    assert nb == (x.numel() + conv.weight.numel() + out.numel()) * 4


def test_conv_concat_and_projection_ops():
    xs = [torch.empty(2, 24, 20, 36, device='meta') for _ in range(3)]
    conv = ref.Conv2d(72, 24, 3).to('meta')
    ops, _ = roofline.conv_concat(xs, conv.weight, None, None)
    assert ops == counted(conv, torch.cat(xs, dim=1))
    x = torch.empty(2, 80, 10, 18, device='meta')
    proj = ref.Conv2d(80, 80, 1).to('meta')
    ops, _ = roofline.naf_back(x, x, torch.empty(2, 80, device='meta'),
                               {'w7_p': None, 'beta': None, 'b7': None})
    assert ops == counted(proj, x)


def test_up_skip_ops_count_its_projection():
    x = torch.empty(2, 48, 10, 18, device='meta')
    skip = torch.empty(2, 36, 20, 36, device='meta')
    proj = ref.Conv2d(48, 36, 1).to('meta')
    ops, nb = roofline.up_skip(x, proj.weight, skip)
    assert ops == counted(proj, x)
    assert nb == (x.numel() + proj.weight.numel() + 2 * skip.numel()) * 4


@pytest.mark.parametrize('depthwise', [False, True])
def test_naf_rep_ops_count_the_merged_5x5_and_the_expand(depthwise):
    n = 48
    g = torch.empty(2, n, 12, 20, device='meta')
    rep = ref.RepConv(n, 5, depthwise).to('meta')
    expand = ref.Conv2d(n, 2 * n, 1).to('meta')
    prep = {'rep': rep.conv_1.weight, 'rep_p': None, 'w4_p': None}
    ops, _ = roofline.naf_rep(g, None, prep)
    assert ops == counted(rep.conv_1, g) + counted(expand, g)


def test_bound_is_the_larger_of_compute_and_memory():
    assert roofline.bound_s(989e12, 0, torch.bfloat16) == pytest.approx(1)
    assert roofline.bound_s(0, 3.35e12, torch.float32) == pytest.approx(1)
    assert roofline.bound_s(495e12, 1.0, torch.float32) == pytest.approx(1)


def test_window_flops_count_repconvs_merged():
    """A restore window's model FLOPs leave out each RepConv's 3x3 branch,
    which inference folds into the kxk conv, and keep the rest."""
    import json

    from benchmark import flops, manifest
    from benchmark.tests.tiny import TINY
    cfg = json.loads((manifest.ROOT / 'benchmark' / 'configs'
                      / 'deblur_plus.json').read_text())
    arch = ref.Arch.from_config(cfg['model'], **TINY)
    t, h, w = 3, 16, 24
    model = flops._model(arch)
    branch = []
    for m in model.modules():
        if isinstance(m, ref.RepConv):
            m.register_forward_hook(lambda mod, inp, out: branch.append(
                2 * mod.conv_2.weight[0].numel() * out.numel()))
    unmerged = counted(model, torch.empty(t, 3, h, w, device='meta'))
    assert branch
    assert flops.window_flops(arch, t, h, w, 'full') == (
        unmerged - sum(branch))
