"""Times of the tensor-core kernels (``cab_front``, ``conv``, ``conv_cat``,
``naf_gate``, ``naf_rep``, ``naf_back``, ``up_skip``) and of the bandwidth
kernels ``shift_round`` and ``cab_back`` at the main path's shapes, beside
their plain versions, cuDNN (or a direct copy, or ``torch.addcmul``) and
their bounds.

  python -m shiftnet_tpu_torch.tools.bench_conv [--tiles] [--f32] [--only K]

Each shape is one that ``chip_smoke.py``'s kernel phase checks (T = 4,
seeded inputs made on the card): for each, the kernel's median time, its
rate (the convs' multiply-adds, 2 operations each, over that time), the
plain version's time (two cuDNN convs and a PReLU for ``cab_front``), one
``F.conv2d`` of the same conv where one call computes it, and the bound:
the larger of the bytes over 3.35 TB/s and the operations over the
type's peak.  ``--tiles`` also times the kernels at every output
tile of ``CAB_TILES`` / ``CONV_TILES`` / ``naf_chw.TILES`` /
``UP_TILES`` that fits, the default pick marked ``*`` (naf_back has one
tile); ``--f32`` adds the float32 forms (with ``--tiles``, at every tile
too); ``--only`` times one kernel family (``cab``, ``conv``, ``cat``
(conv_cat), ``naf`` (naf_gate and naf_rep), ``back`` (naf_back), ``up``
(up_skip), ``shift`` (shift_round) or ``cabback`` (cab_back)).  The naf
blocks' weights are seeded ``init_state`` weights of a CAB2 / CAB1,
through ``prep_naf``; up_skip's and conv_cat's weights are seeded in the
activation type and their panels packed once, as the model's are, before
the timed runs.  conv_cat's line
adds ``conv`` over the concat (the cat not timed); shift_round's library
column is a direct copy of the same bytes (``Tensor.copy_`` of x into y
and of the moved channels into hw), and it computes nothing, so its rate
reads 0.  cab_back's line adds its time in place (as the level chains run
it) and its route (16-byte units or elements); its library column is
``torch.addcmul(x, s, ca[:, :, None, None])``.

The script reads only the ops' public functions, so it also times an
older checkout of the port: ``PYTHONPATH=<checkout> python
shiftnet_tpu_torch/tools/bench_conv.py`` (without ``--tiles``, which needs
this checkout's tile arguments).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from shiftnet_tpu_torch.models import init_state, layers
from shiftnet_tpu_torch.ops import chw, naf_chw
from shiftnet_tpu_torch.tools.timing import card, median_ms, require_cuda

H, W, T = 720, 1280, 4
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM = 3.35e12
# cab_front: (C, h, w): the TFR widths of the big and small variants, and
# Encoder2's widths at H/2.
CAB_SHAPES = ((24, H, W), (36, H // 2, W // 2), (48, H // 4, W // 4),
              (80, H // 2, W // 2), (14, H, W), (18, H // 2, W // 2),
              (22, H // 4, W // 4), (64, H // 2, W // 2))
# conv: (cin, cout, k, stride, bias, prelu, h, w), each main-path conv.
CONV_SHAPES = (
    (24, 36, 3, 2, True, False, H, W),             # TFR down12
    (36, 48, 3, 2, True, False, H // 2, W // 2),   # TFR down23
    (24, 24, 3, 1, False, True, H // 2, W // 2),
    (24, 3, 5, 1, False, False, H, W),             # conv_last
    (3, 24, 3, 1, True, False, H, W),              # feat_extract
    (24, 80, 2, 2, False, True, H, W),             # down01
    (80, 96, 3, 1, True, False, H // 2, W // 2),   # upsample_conv
    (72, 24, 3, 1, True, False, H, W),             # rconcat
    (14, 64, 2, 2, False, True, H, W),             # small: down01
    (64, 56, 3, 1, False, False, H // 2, W // 2),  # small: upsample_conv
    (14, 14, 3, 1, False, False, H, W),            # small: conv_hr0
    (3, 14, 3, 1, True, False, H, W),              # small: feat_extract
    (14, 3, 5, 1, False, False, H, W),             # small: conv_last
)

# naf_gate: (n, CAB2, h, w), the big variants' three Encoder2 levels, then
# CAB1 and the small variants' width; naf_rep: (n, depthwise, cag, h, w).
GATE_SHAPES = ((80, True, H // 2, W // 2), (80, False, H // 2, W // 2),
               (80, True, H // 4, W // 4), (80, True, H // 8, W // 8),
               (64, True, H // 2, W // 2), (64, False, H // 2, W // 2))
REP_SHAPES = ((80, False, False, H // 2, W // 2),
              (80, False, True, H // 2, W // 2),
              (80, False, False, H // 4, W // 4),
              (64, True, False, H // 2, W // 2),
              (64, True, True, H // 2, W // 2))
# naf_back: (n, b7, h, w): the big variants' three Encoder2 levels, the
# denoise variants' biased projection, the small variants' width.
BACK_SHAPES = ((80, False, H // 2, W // 2), (80, True, H // 2, W // 2),
               (80, False, H // 4, W // 4), (80, False, H // 8, W // 8),
               (64, False, H // 2, W // 2))
# conv_cat: (n_in, C, bias, prelu, h, w), C -> C over an n_in-input concat:
# deblur rconcat and conv_hr0, denoise rconcat, deblur_small rconcat,
# denoise_small conv_hr0 (chip_smoke.py's shapes).
CAT_SHAPES = ((3, 24, True, False, H, W), (2, 24, True, False, H, W),
              (3, 24, False, True, 480, 848), (3, 14, True, False, H, W),
              (2, 14, True, False, 480, 848))
# shift_round: (C, number, reverse, patch, h, w): the big variants' three
# Encoder2 levels, then the small variants' width.
SHIFT_SHAPES = ((80, 5, False, True, H // 2, W // 2),
                (80, 5, True, True, H // 2, W // 2),
                (80, 5, False, True, H // 4, W // 4),
                (80, 5, False, True, H // 8, W // 8),
                (64, 4, False, False, H // 2, W // 2))
# up_skip: (cin, cout, h, w) at low resolution: the TFR U-Nets' up21 and
# up32 and Encoder2's up21, big then small.
UP_SHAPES = ((36, 24, H // 2, W // 2), (48, 36, H // 4, W // 4),
             (80, 80, H // 4, W // 4), (18, 14, H // 2, W // 2),
             (22, 18, H // 4, W // 4), (64, 64, H // 4, W // 4))


def _randn(shape, seed, dtype, scale=1.0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device='cuda')).to(dtype)


def _line(label, ms, ops, nbytes, dtype, plain, lib, tag, extra=''):
    bound = max(1e3 * nbytes / HBM, 1e3 * ops / PEAK[dtype])
    print(f'{label:40s} {str(dtype)[6:]:8s} {tag:7s} {ms:8.3f} ms '
          f'{ops / ms / 1e9:7.1f} TF/s | plain {plain:7.3f} | library '
          f'{"none" if lib is None else f"{lib:.3f}"} | bound {bound:.3f} '
          f'ms{extra}', flush=True)


def bench_cab(dtype, tiles):
    for c, h, w in CAB_SHAPES:
        x = _randn((T, c, h, w), c, dtype)
        w1 = _randn((c, c, 3, 3), c + 1, dtype, (9 * c) ** -0.5)
        w2 = _randn((c, c, 3, 3), c + 2, dtype, (9 * c) ** -0.5)
        alpha = torch.full((1,), 0.25, device='cuda')
        ops = 2 * 2 * 9 * c * c * T * h * w
        nbytes = 2 * x.numel() * x.element_size()
        plain = median_ms(lambda: chw.cab_front_plain(x, w1, alpha, w2))
        label = f'cab_front C={c} {h}x{w}'
        runs = [('', {})]
        if tiles:
            size = x.element_size()
            pick = chw.cab_front_tile(c, size)
            runs = [(f'{th}x{tw}{"*" if (th, tw) == pick else ""}',
                     dict(tile=(th, tw))) for th, tw in chw.CAB_TILES
                    if chw.cab_front_smem(c, size, th, tw) <= chw.SMEM_BYTES]
        for tag, kw in runs:
            ms = median_ms(lambda: chw.cab_front(x, w1, alpha, w2, **kw))
            _line(label, ms, ops, nbytes, dtype, plain, None, tag)
        del x


def bench_conv(dtype, tiles):
    for i, (cin, cout, k, st, bias, pre, h, w) in enumerate(CONV_SHAPES):
        x = _randn((T, cin, h, w), i, dtype)
        wt = _randn((cout, cin, k, k), 100 + i, dtype, (k * k * cin) ** -0.5)
        b = _randn((cout,), 200 + i, torch.float32, 0.01) if bias else None
        a = torch.full((1,), 0.25, device='cuda') if pre else None
        pad = chw.conv_pad(k, st)
        ho, wo = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
        ops = 2 * k * k * cin * cout * T * ho * wo
        nbytes = (x.numel() + T * cout * ho * wo) * x.element_size()
        plain = median_ms(lambda: chw.conv_plain(x, wt, b, a, st))
        lib = None
        if not pre:
            bl = None if b is None else b.to(dtype)
            lib = median_ms(lambda: F.conv2d(x, wt, bl, st, pad))
        label = (f'conv {cin}->{cout} k{k} s{st}{" bias" if bias else ""}'
                 f'{" prelu" if pre else ""} {h}x{w}')
        runs = [('', {})]
        if tiles:
            size = x.element_size()
            pick = chw.conv_tile(cin, cout, k, st, size)
            runs = [(f'{th}x{tw}{"*" if (th, tw) == pick else ""}',
                     dict(tile=(th, tw))) for th, tw in chw.CONV_TILES
                    if chw.conv_smem(cin, cout, k, st, th, tw, size)
                    <= chw.SMEM_BYTES]
        for tag, kw in runs:
            ms = median_ms(lambda: chw.conv(x, wt, b, a, st, **kw))
            _line(label, ms, ops, nbytes, dtype, plain, lib, tag)
        del x


def bench_cat(dtype, tiles):
    for i, (n_in, c, bias, pre, h, w) in enumerate(CAT_SHAPES):
        xs = [_randn((T, c, h, w), 1400 + 3 * i + s, dtype)
              for s in range(n_in)]
        with torch.inference_mode(False):  # a weight whose panel is kept
            wt = _randn((c, n_in * c, 3, 3), 1500 + i, dtype,
                        (9 * n_in * c) ** -0.5)
        b = _randn((c,), 1600 + i, torch.float32, 0.01) if bias else None
        a = torch.full((1,), 0.25, device='cuda') if pre else None
        xcat = torch.cat(xs, 1)
        ops = 2 * 9 * n_in * c * c * T * h * w
        nbytes = (n_in + 1) * c * T * h * w * xcat.element_size()
        plain = median_ms(lambda: chw.conv_concat_plain(xs, wt, b, a))
        lib = None
        if not pre:
            bl = None if b is None else b.to(dtype)
            lib = median_ms(lambda: F.conv2d(xcat, wt, bl, 1, 1))
        on_cat = median_ms(lambda: chw.conv(xcat, wt, b, a, 1))
        label = (f'conv_cat {n_in}x{c}->{c}{" bias" if bias else ""}'
                 f'{" prelu" if pre else ""} {h}x{w}')
        runs = [('', {})]
        if tiles:
            size = xcat.element_size()
            pick = chw.conv_cat_tile(n_in, c, c, size)
            runs = [(f'{th}x{tw}{"*" if (th, tw) == pick else ""}',
                     dict(tile=(th, tw))) for th, tw in chw.CONV_TILES
                    if chw.conv_cat_smem(n_in, c, c, size, th, tw)
                    <= chw.SMEM_BYTES]
        for tag, kw in runs:
            ms = median_ms(lambda: chw.conv_concat(xs, wt, b, a, **kw))
            _line(label, ms, ops, nbytes, dtype, plain, lib, tag,
                  f' | conv on the concat {on_cat:.3f}')
        del xs, xcat


def bench_shift(dtype, tiles):
    for i, (c, number, reverse, patch, h, w) in enumerate(SHIFT_SHAPES):
        x = _randn((T, c, h, w), 1700 + i, dtype)
        add_c = 8 * number
        y, hw = torch.empty_like(x), x.new_empty((T, add_c, h, w))
        kw = dict(reverse=reverse, boundary_patch=patch)
        nbytes = (2 * c + add_c) * T * h * w * x.element_size()
        plain = median_ms(lambda: naf_chw.shift_round_plain(x, number, **kw))

        def copy():
            y.copy_(x)
            hw.copy_(x[:, :add_c])
        lib = median_ms(copy)
        ms = median_ms(lambda: naf_chw.shift_round(x, number, **kw))
        label = (f'shift_round C={c} n={number} '
                 f'{"reverse" if reverse else "forward"}'
                 f'{" patch" if patch else ""} {h}x{w}')
        _line(label, ms, 0, nbytes, dtype, plain, lib, '')
        del x, y, hw


def _naf_prep(n, cab2, depthwise, dtype, seed):
    kw = dict(kernel_size=5, reduction=4, mid_ca=True, last_bias=True,
              repconv_depthwise=depthwise)
    mod = layers.CAB2(n, n // 2, **kw) if cab2 else layers.CAB1(n, **kw)
    mod.load_state_dict(init_state(mod, seed), strict=True)
    p = {k: v.detach().cuda() for k, v in mod.named_parameters()}
    return naf_chw.prep_naf(p, '', dtype, mid_ca=True, last_bias=True)


def _naf_runs(tiles, smem, pick):
    """[(tag, kwargs)]: the default tile, or with ``tiles`` every tile of
    ``naf_chw.TILES`` that fits (``smem``), the pick (``pick()``) marked."""
    if not tiles:
        return [('', {})]
    best = pick()
    return [(f'{th}x{tw}{"*" if (th, tw) == best else ""}',
             dict(tile=(th, tw))) for th, tw in naf_chw.TILES
            if smem(th, tw) <= chw.SMEM_BYTES]


def bench_naf(dtype, tiles):
    size = torch.tensor([], dtype=dtype).element_size()
    for i, (n, cab2, h, w) in enumerate(GATE_SHAPES):
        prep = _naf_prep(n, cab2, n == 64, dtype, 300 + i)
        add_c = n // 2 if cab2 else 0
        y = _randn((T, n, h, w), 400 + i, dtype)
        hw = _randn((T, add_c, h, w), 500 + i, dtype) if cab2 else None
        px, cin = T * h * w, n + add_c
        ops = 2 * px * (2 * n * cin + 9 * add_c + 9 * 2 * n) + px * n
        nbytes = (2 * n + add_c) * px * size
        plain = median_ms(lambda: naf_chw.naf_gate_plain(y, hw, prep))
        label = f'naf_gate {"CAB2" if cab2 else "CAB1"} n={n} {h}x{w}'
        runs = _naf_runs(
            tiles, lambda th, tw: naf_chw.naf_gate_smem(n, add_c, size, th,
                                                        tw),
            lambda: naf_chw.naf_gate_tile(n, add_c, size))
        for tag, kw in runs:
            ms = median_ms(lambda: naf_chw.naf_gate(y, hw, prep, **kw))
            _line(label, ms, ops, nbytes, dtype, plain, None, tag)
        del y, hw
    for i, (n, dw, opts, h, w) in enumerate(REP_SHAPES):
        prep = _naf_prep(n, True, dw, dtype, 600 + i)
        g = _randn((T, n, h, w), 700 + i, dtype)
        cag = torch.rand((T, n), device='cuda').to(dtype) if opts else None
        group = 1 if dw else 8
        px = T * h * w
        ops = 2 * px * (25 * group * n + 2 * n * n)
        nbytes = 2 * n * px * size
        plain = median_ms(lambda: naf_chw.naf_rep_plain(g, cag, prep))
        label = (f'naf_rep{" depthwise" if dw else ""} n={n} {h}x{w}'
                 f'{" cag" if opts else ""}')
        runs = _naf_runs(
            tiles, lambda th, tw: naf_chw.naf_rep_smem(n, size, th, tw,
                                                       group),
            lambda: naf_chw.naf_rep_tile(n, size, group))
        for tag, kw in runs:
            ms = median_ms(lambda: naf_chw.naf_rep(g, cag, prep, **kw))
            _line(label, ms, ops, nbytes, dtype, plain, None, tag)
        del g


def bench_back(dtype, tiles):
    for i, (n, b7, h, w) in enumerate(BACK_SHAPES):
        prep = _naf_prep(n, False, n == 64, dtype, 800 + i)
        if not b7:
            prep = dict(prep, b7=None)
        y = _randn((T, n, h, w), 900 + i, dtype)
        s = _randn((T, n, h, w), 1000 + i, dtype)
        ca = torch.rand((T, n), device='cuda').to(dtype)
        px = T * h * w
        ops = 2 * px * n * n
        nbytes = 3 * n * px * y.element_size()
        plain = median_ms(lambda: naf_chw.naf_back_plain(y, s, ca, prep))
        label = f'naf_back n={n} {h}x{w}{" b7" if b7 else ""}'
        ms = median_ms(lambda: naf_chw.naf_back(y, s, ca, prep))
        _line(label, ms, ops, nbytes, dtype, plain, None, '')
        del y, s


def bench_up(dtype, tiles):
    size = torch.tensor([], dtype=dtype).element_size()
    for i, (cin, cout, h, w) in enumerate(UP_SHAPES):
        x = _randn((T, cin, h, w), 1100 + i, dtype)
        with torch.inference_mode(False):  # a weight whose panel is kept
            w11 = _randn((cout, cin, 1, 1), 1200 + i, dtype, cin ** -0.5)
        skip = _randn((T, cout, 2 * h, 2 * w), 1300 + i, dtype)
        ops = 2 * cin * cout * T * h * w
        nbytes = (x.numel() + 2 * skip.numel()) * size
        plain = median_ms(lambda: chw.up_skip_plain(x, w11, skip))
        label = f'up_skip {cin}->{cout} {h}x{w}->{2 * h}x{2 * w}'
        runs = [('', {})]
        if tiles:
            pick = chw.up_skip_tile(cin, cout, size)
            runs = [(f'{th}x{tw}{"*" if (th, tw) == pick else ""}',
                     dict(tile=(th, tw))) for th, tw in chw.UP_TILES
                    if chw.up_skip_smem(cin, cout, size, th, tw)
                    <= chw.SMEM_BYTES]
        for tag, kw in runs:
            ms = median_ms(lambda: chw.up_skip(x, w11, skip, **kw))
            _line(label, ms, ops, nbytes, dtype, plain, None, tag)
        del x, skip


def bench_cabback(dtype, tiles):
    # an older checkout of the port has one route and no cab_back_route
    route_of = getattr(chw, 'cab_back_route', None)
    for i, (c, h, w) in enumerate(CAB_SHAPES):
        x = _randn((T, c, h, w), 1800 + i, dtype)
        s = _randn((T, c, h, w), 1900 + i, dtype)
        ca = torch.sigmoid(_randn((T, c), 2000 + i, torch.float32)).to(dtype)
        xc = x.clone()
        nbytes = (3 * x.numel() + ca.numel()) * x.element_size()
        plain = median_ms(lambda: chw.cab_back_plain(x, s, ca))
        lib = median_ms(lambda: torch.addcmul(x, s, ca[:, :, None, None]))
        ms = median_ms(lambda: chw.cab_back(x, s, ca))
        inplace = median_ms(lambda: chw.cab_back(xc, s, ca, inplace=True))
        route = route_of(x, s, x) if route_of else 'one'
        _line(f'cab_back C={c} {h}x{w}', ms, 2 * x.numel(), nbytes, dtype,
              plain, lib, '', f' | in place {inplace:.3f} | route {route}')
        del x, s, xc


FAMILIES = (('cab', bench_cab), ('conv', bench_conv), ('cat', bench_cat),
            ('naf', bench_naf), ('back', bench_back), ('up', bench_up),
            ('shift', bench_shift), ('cabback', bench_cabback))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tiles', action='store_true',
                    help='time the kernels at every tile that fits')
    ap.add_argument('--f32', action='store_true',
                    help='also time the float32 forms')
    ap.add_argument('--only', choices=[name for name, _ in FAMILIES],
                    help='time one kernel family')
    args = ap.parse_args(argv)
    require_cuda('bench_conv')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'bench_conv: T={T}, {card()}, torch {torch.__version__}',
          flush=True)
    with torch.inference_mode():
        for dtype in (torch.bfloat16,) + ((torch.float32,) if args.f32
                                          else ()):
            for name, bench in FAMILIES:
                if args.only in (None, name):
                    bench(dtype, args.tiles)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
