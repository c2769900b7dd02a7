"""The port's validation layer against the JAX package's, on the CPU: the
colour conversions, MATLAB imresize, the BasicSR PSNR / SSIM, NIQE and its
pristine statistics, the metric registry, the torch metrics, the grids
tiling with rot/flip TTA, ``Evaluator.forward_grids``, both CLIs with
``--metric``, ``--grids`` and ``--profile``, the tracing helpers and the
drift tool.

The numpy copies are held to 1e-12 (they are the JAX package's arithmetic
run again); NIQE to 5e-3 of the reference's recorded value as the JAX test
holds it; the model paths to a normalized max error of 1e-4 in float32.
"""
import functools
import hashlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conftest import load_fixture
from shiftnet_tpu.eval import basicsr_metrics as jbm
from shiftnet_tpu.eval import color as jcolor
from shiftnet_tpu.eval import grids as jgrids
from shiftnet_tpu.eval import imresize as jimresize
from shiftnet_tpu.eval import metrics as jmetrics
from shiftnet_tpu.eval import niqe as jniqe
from shiftnet_tpu.eval import registry as jregistry
from shiftnet_tpu.eval.runner import Evaluator as JaxEvaluator
from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from shiftnet_tpu_torch.eval import (basicsr_metrics, color, grids, imresize,
                                     metrics, niqe, registry, runner)
from shiftnet_tpu_torch.eval.runner import Evaluator
from shiftnet_tpu_torch.models import build_model, init_state
from shiftnet_tpu_torch.tools import measure_drift, test_deblur, test_denoise
from shiftnet_tpu_torch.utils.profiling import PhaseTimer, trace

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices('cpu')[0]
EXACT = dict(rtol=0, atol=1e-12)
GOLDEN_NIQE = 19.024456919250227  # tests/test_niqe.py
# narrow widths, one orb, two shift rounds (tests/test_torch_small.py)
TINY = dict(n_feats0=8, n_feats2=32, num_orbs=1, shift_rounds=2)
HALO = 2


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The models here are narrow: one intra-op thread runs them as fast
    as many, and leaves the cores to the suites running beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def pair(shape, seed, noise=12.0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 255, shape)
    return np.clip(gt + rng.normal(0, noise, shape), 0, 255), gt


def niqe_image():
    """tests/test_niqe.py's synthetic image, whose reference NIQE is
    GOLDEN_NIQE."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:128, 0:160]
    img = (128 + 60 * np.sin(yy / 7.0) * np.cos(xx / 11.0)
           + rng.normal(0, 12, (128, 160)))
    img = np.clip(img, 0, 255).astype(np.float32)
    return np.stack([img, img * 0.9, img * 0.8], axis=-1)


# -- colour, imresize, BasicSR PSNR / SSIM ------------------------------------

@pytest.mark.parametrize('fn', ['rgb2ycbcr', 'rgb2ycbcr_y', 'bgr2ycbcr',
                                'bgr2ycbcr_y', 'ycbcr2rgb', 'to_y_channel',
                                'reorder_chw', 'reorder_2d'])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_color_matches_jax(fn, dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 28, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.0
    calls = {
        'rgb2ycbcr': lambda m: m.rgb2ycbcr(img),
        'rgb2ycbcr_y': lambda m: m.rgb2ycbcr(img, y_only=True),
        'bgr2ycbcr': lambda m: m.bgr2ycbcr(img),
        'bgr2ycbcr_y': lambda m: m.bgr2ycbcr(img, y_only=True),
        'ycbcr2rgb': lambda m: m.ycbcr2rgb(img),
        'to_y_channel': lambda m: m.to_y_channel(img * 1.0),
        'reorder_chw': lambda m: m.reorder_image(img.transpose(2, 0, 1),
                                                 'CHW'),
        'reorder_2d': lambda m: m.reorder_image(img[..., 0])}
    got, want = calls[fn](color), calls[fn](jcolor)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **EXACT)


def test_color_matches_fixture():
    fx = load_fixture('metrics_basicsr')
    img = fx['img'] / 255.0
    np.testing.assert_allclose(color.rgb2ycbcr(img, y_only=True),
                               fx['rgb2y'], atol=1e-5)
    np.testing.assert_allclose(color.rgb2ycbcr(img), fx['rgb2ycbcr'],
                               atol=1e-5)
    np.testing.assert_allclose(color.bgr2ycbcr(img, y_only=True),
                               fx['bgr2y'], atol=1e-5)
    with pytest.raises(ValueError):
        color.reorder_image(img, 'WHC')


@pytest.mark.parametrize('scale,antialias', [(0.5, True), (2.0, True),
                                             (0.75, True), (0.5, False),
                                             (1 / 3, True)])
@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
def test_imresize_matches_jax(scale, antialias, dtype):
    img = np.random.default_rng(2).uniform(0, 255, (37, 53, 3)).astype(dtype)
    got = imresize.imresize(img, scale, antialias)
    want = jimresize.imresize(img, scale, antialias)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(imresize.imresize(img[..., 0], scale,
                                                 antialias),
                               jimresize.imresize(img[..., 0], scale,
                                                  antialias), **EXACT)


def test_imresize_matches_fixture():
    fx = load_fixture('metrics_basicsr')
    np.testing.assert_allclose(imresize.imresize(fx['resize_in'], 0.5, True),
                               fx['resize_half'], atol=5e-6)
    np.testing.assert_allclose(imresize.imresize(fx['resize_in'], 2.0, True),
                               fx['resize_2x'], atol=5e-6)


@pytest.mark.parametrize('name', ['calculate_psnr', 'calculate_ssim'])
@pytest.mark.parametrize('kw', [{}, {'crop_border': 4},
                                {'test_y_channel': True},
                                {'crop_border': 3, 'test_y_channel': True},
                                {'input_order': 'CHW'}])
def test_basicsr_metrics_match_jax(name, kw):
    img, gt = pair((40, 48, 3), 3)
    if kw.get('input_order') == 'CHW':
        img, gt = img.transpose(2, 0, 1), gt.transpose(2, 0, 1)
    got = getattr(basicsr_metrics, name)(img, gt, **kw)
    want = getattr(jbm, name)(img, gt, **kw)
    assert got == pytest.approx(want, rel=0, abs=1e-12)


def test_basicsr_metrics_match_fixture():
    fx = load_fixture('metrics_basicsr')
    img, img2 = fx['img'], fx['img2']
    cp, cs = basicsr_metrics.calculate_psnr, basicsr_metrics.calculate_ssim
    assert abs(cp(img, img2, crop_border=4) - float(fx['psnr_cb4'])) < 1e-8
    assert abs(cp(img, img2, test_y_channel=True)
               - float(fx['psnr_y'])) < 1e-6
    assert abs(cs(img, img2) - float(fx['ssim_cb0'])) < 2e-5
    assert abs(cs(img, img2, crop_border=4, test_y_channel=True)
               - float(fx['ssim_y'])) < 1e-6
    assert cp(img, img) == float('inf')


# -- NIQE ---------------------------------------------------------------------

def test_niqe_params_are_the_jax_packages_bytes():
    port = REPO / 'shiftnet_tpu_torch/eval/data/niqe_pris_params.npz'
    jax_file = REPO / 'shiftnet_tpu/eval/data/niqe_pris_params.npz'
    assert (hashlib.sha256(port.read_bytes()).hexdigest()
            == hashlib.sha256(jax_file.read_bytes()).hexdigest())
    assert Path(niqe._PARAMS).resolve() == port.resolve()
    mu, cov, window = niqe.load_pris_params()
    assert mu.shape == (1, 36) and cov.shape == (36, 36)
    assert window.shape == (7, 7)
    with pytest.raises(FileNotFoundError):
        niqe.load_pris_params(str(REPO / 'no_such_params.npz'))


def test_niqe_matches_golden_and_jax():
    got = niqe.calculate_niqe(niqe_image(), crop_border=0, input_order='HWC',
                              convert_to='y')
    assert abs(got - GOLDEN_NIQE) < 5e-3
    assert got == pytest.approx(jniqe.calculate_niqe(niqe_image()), rel=0,
                                abs=1e-12)


@pytest.mark.parametrize('shape,convert_to,crop', [
    ((200, 300, 3), 'y', 0), ((290, 389, 3), 'gray', 1),
    ((200, 301, 3), 'gray', 0), ((193, 291, 3), 'y', 2)])
def test_niqe_matches_jax(shape, convert_to, crop):
    """Odd widths take OpenCV's scalar tail in the JAX package's grey
    conversion; the port writes that arithmetic out."""
    img = np.random.default_rng(4).uniform(0, 255, shape)
    got = niqe.calculate_niqe(img, crop_border=crop, convert_to=convert_to)
    want = jniqe.calculate_niqe(img, crop_border=crop, convert_to=convert_to)
    assert got == pytest.approx(want, rel=0, abs=1e-12)


@pytest.mark.parametrize('w', [1, 5, 7, 8, 13, 389])
def test_niqe_opencv_steps_written_out(w):
    """The two OpenCV calls of the JAX package's NIQE, bit for bit: BGR to
    grey at widths around its 8-pixel runs, and the half-size resize."""
    cv2 = pytest.importorskip('cv2')
    img = (np.random.default_rng(w).uniform(0, 255, (30, w, 3))
           .astype(np.float32) / 255.0)
    np.testing.assert_array_equal(niqe._bgr2gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    y = np.random.default_rng(w).uniform(0, 255, (96, 96 * (w % 3 + 1)))
    y = y.astype(np.float32) / 255.0
    np.testing.assert_array_equal(
        niqe._half_linear(y), cv2.resize(y, (y.shape[1] // 2, 48),
                                         interpolation=cv2.INTER_LINEAR))


# -- the registry and the torch metrics ----------------------------------------

def test_registry_surface_matches_jax():
    assert set(registry.METRIC_FUNCS) == set(jregistry.METRIC_FUNCS)
    assert registry.NO_REFERENCE == jregistry.NO_REFERENCE
    assert registry.METRIC_FUNCS['psnr'] is metrics.psnr
    assert registry.METRIC_FUNCS['ssim'] is metrics.ssim


@pytest.mark.parametrize('opt', [
    {'type': 'psnr'}, {'type': 'ssim'},
    {'type': 'calculate_psnr', 'crop_border': 4},
    {'type': 'calculate_psnr', 'test_y_channel': True},
    {'type': 'calculate_ssim', 'crop_border': 2, 'test_y_channel': True},
    {'type': 'calculate_niqe', 'crop_border': 0}])
def test_registry_dispatch_matches_jax(opt):
    img, gt = pair((128, 112, 3), 5)
    data = {'img': img, 'img2': gt}
    got = registry.calculate_metric(data, opt)
    assert got == pytest.approx(jregistry.calculate_metric(data, opt),
                                rel=0, abs=1e-12)
    assert opt.get('type')  # the caller's dict is left whole


def test_score_pair_matches_jax():
    img, gt = pair((128, 96, 3), 6)
    cfg = {'psnr': {'type': 'psnr'}, 'ssim': {'type': 'ssim'},
           'niqe': {'type': 'calculate_niqe'},
           'psnr_y': {'type': 'calculate_psnr', 'test_y_channel': True}}
    got = registry.score_pair(img, gt, cfg)
    want = jregistry.score_pair(img, gt, cfg)
    assert list(got) == list(cfg)
    for k in cfg:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12)


@pytest.mark.parametrize('shape', [(2, 24, 32, 3), (3, 17, 21, 3)])
def test_torch_metrics_match_jax(shape):
    img, gt = pair(shape, 7)
    img, gt = img.astype(np.float32), gt.astype(np.float32)
    p = metrics.psnr_t(torch.from_numpy(img), torch.from_numpy(gt))
    s = metrics.ssim_t(torch.from_numpy(img), torch.from_numpy(gt))
    assert p.shape == s.shape == (shape[0],)
    assert p.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(
        p.numpy(), np.asarray(jmetrics.psnr_jax(jnp.asarray(img),
                                                jnp.asarray(gt))), rtol=1e-6)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jmetrics.ssim_jax(jnp.asarray(img),
                                                jnp.asarray(gt))), atol=1e-6)
    for i in range(shape[0]):
        assert abs(float(p[i]) - metrics.psnr(img[i], gt[i])) < 1e-3
        assert abs(float(s[i]) - metrics.ssim(img[i], gt[i])) < 2e-4


# -- grids ----------------------------------------------------------------------

@pytest.mark.parametrize('h,w,crop,trans_num', [
    (100, 130, 48, 1), (256, 256, 256, 1), (97, 53, 32, 8), (70, 90, 32, 8),
    (720, 1280, 256, 1), (480, 852, 256, 8), (48, 64, 32, 3)])
def test_grids_match_jax(h, w, crop, trans_num):
    plans = grids.plan_grids(h, w, crop, trans_num)
    jplans = jgrids.plan_grids(h, w, crop, trans_num)
    assert [vars(p) for p in plans] == [vars(p) for p in jplans]
    cover = np.zeros((h, w), np.int32)
    for p in plans:
        cover[p.i:p.i + crop, p.j:p.j + crop] += 1
    assert (cover >= trans_num).all()
    if (h, w) == (720, 1280):
        assert len(plans) == 15
    if (h, w) == (480, 852):
        assert len(plans) == 64
    clip = np.random.default_rng(h).uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)
    parts = grids.extract_grids(clip, plans, crop)
    jparts = jgrids.extract_grids(clip, jplans, crop)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a, b)
    preds = [np.sin(3 * np.asarray(a)) for a in parts]  # any crop-wise map
    merged = grids.merge_grids(preds, plans, clip.shape, crop)
    np.testing.assert_array_equal(
        merged, jgrids.merge_grids(preds, jplans, clip.shape, crop))
    np.testing.assert_allclose(grids.merge_grids(parts, plans, clip.shape,
                                                 crop), clip, atol=1e-6)


def test_transpose_roundtrip():
    x = np.random.default_rng(0).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    for t in range(8):
        y = grids.transpose_fwd(x, t)
        np.testing.assert_array_equal(y, jgrids.transpose_fwd(x, t))
        back = grids.transpose_inv(y, t)
        assert back.flags.c_contiguous
        np.testing.assert_array_equal(back, x)


# -- forward_grids --------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """(port state, a float32 JAX Evaluator, unfused, on the same weights)
    of a narrow deblur_small, the cheapest model for JAX to compile."""
    state = init_state(build_model('deblur_small', **TINY), seed=11)
    jmodel = jax_build_model('deblur_small', past_frames=HALO,
                             future_frames=HALO, **TINY)
    tpl = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2 * HALO + 1, 32, 32, 3))))
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl['params'])
    jev = JaxEvaluator('deblur_small', params, bf16=False,
                       result_path=str(tmp_path_factory.mktemp('jax_eval')),
                       overrides={'fused_chw': False, **TINY})
    return state, jev


def port_evaluator(state, path, **kw):
    return Evaluator('deblur_small', state, device='cpu', bf16=False,
                     overrides=TINY, result_path=str(path), **kw)


def clip(t, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (t, h, w, 3)).astype(
        np.float32)


def test_forward_grids_tta_matches_jax(tiny, tmp_path):
    """Two 32x32 crops of a 32x48 window, 8 transforms each: 16 forwards of
    one crop shape, so JAX compiles once."""
    state, jev = tiny
    x = clip(2 * HALO + 1, 32, 48, 21)
    ev = port_evaluator(state, tmp_path)
    got = ev.forward_grids(x, crop_size=32, trans_num=8)
    want = jev.forward_grids(x, crop_size=32, trans_num=8)
    assert got.shape == want.shape == (1, 32, 48, 3)
    assert got.dtype == np.float32
    assert norm_err(got, want) < 1e-4
    assert '[grids] window (5, 32, 48, 3)' in Path(
        ev.logger.path).read_text()


def test_forward_grids_frame_covering_crop_is_forward_window(tiny, tmp_path):
    state, _ = tiny
    x = clip(2 * HALO + 2, 48, 48, 22)
    ev = port_evaluator(state, tmp_path)
    np.testing.assert_array_equal(ev.forward_grids(x, crop_size=64),
                                  ev.forward_window(x))


def test_forward_grids_refuses_what_the_model_cannot_run(tiny, tmp_path):
    state, _ = tiny
    ev = port_evaluator(state, tmp_path)
    with pytest.raises(ValueError, match='multiple of 8'):
        ev.forward_grids(clip(5, 36, 40, 0), crop_size=36)
    with pytest.raises(ValueError, match='sigma'):
        ev.forward_grids(clip(5, 32, 32, 0), 0.1, crop_size=32)


def test_bf16_input_rounding_matches_jax():
    """The JAX Evaluator casts the uint8 clip to bf16 and then divides by
    255; the port divides in float32 and then casts: the same bf16 values."""
    v = np.arange(256, dtype=np.uint8)
    want = np.asarray((jnp.asarray(v, jnp.bfloat16) / 255.0).astype(
        jnp.float32))
    got = torch.from_numpy(v.astype(np.float32) / 255.0).bfloat16().float()
    np.testing.assert_array_equal(got.numpy(), want)


def test_evaluator_metrics_default_and_configured(tiny, tmp_path):
    state, jev = tiny
    assert port_evaluator(state, tmp_path).metrics == jev.metrics
    cfg = {'niqe': {'type': 'calculate_niqe'}}
    ev = port_evaluator(state, tmp_path, metrics=cfg)
    assert ev.metrics == cfg and ev.metrics is not cfg
    with pytest.raises(ValueError, match='unknown metric types'):
        port_evaluator(state, tmp_path, metrics={'q': {'type': 'niqe'}})


def test_eval_denoise_grids_draws_the_same_noise(tmp_path, monkeypatch):
    """The seeded noise comes in the same order with and without --grids,
    so a seed gives grids and windowed runs (and both packages) the same
    noisy clips."""
    data = tmp_path / 'data'
    write_frames({'gt': data}, ('clip1', 'clip2'), 5, 16, 24, 24)
    state = init_state(build_model('denoise_small', **TINY), seed=3)
    ev = Evaluator('denoise_small', state, device='cpu', bf16=False,
                   overrides=TINY, result_path=str(tmp_path / 'out'))
    seen = {}

    def record(key):
        def forward(x, sigma, **kw):
            seen.setdefault(key, []).append((x.copy(), sigma, kw))
            return np.zeros((x.shape[0] - 2 * HALO,) + x.shape[1:],
                            np.float32)
        return forward
    monkeypatch.setattr(ev, 'forward_window', record('window'))
    monkeypatch.setattr(ev, 'forward_grids', record('grids'))
    ev.eval_denoise(str(data), 10.0, seed=7)
    ev.eval_denoise(str(data), 10.0, seed=7, grids=True, crop_size=16,
                    trans_num=4)
    assert len(seen['window']) == len(seen['grids']) == 2
    for (xw, sw, _), (xg, sg, kw) in zip(seen['window'], seen['grids']):
        np.testing.assert_array_equal(xw, xg)
        assert sw == sg == 10.0 / 255.0
        assert kw == {'crop_size': 16, 'trans_num': 4}


# -- the CLIs, tracing ----------------------------------------------------------

def write_frames(root, videos, t, h, w, seed):
    rng = np.random.default_rng(seed)
    for v in videos:
        base = rng.integers(0, 255, (h, w, 3))
        for sub, d in root.items():
            (d / v).mkdir(parents=True)
            for i in range(t):
                img = np.clip(base + rng.integers(-8, 8, (h, w, 3)), 0, 255)
                Image.fromarray(img.astype(np.uint8)).save(
                    d / v / f'{i:03d}.png')


def state_npz(variant, path, **widths):
    state = init_state(build_model(variant, **widths), seed=15)
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    return str(path)


def read_trace(logdir):
    traces = list(Path(logdir).glob('*.json'))
    assert len(traces) == 1
    return json.loads(traces[0].read_text())


@pytest.mark.parametrize('variant', ['deblur_small', 'denoise_small'])
def test_cli_metric_grids_profile(variant, tmp_path, capsys, monkeypatch):
    """Each CLI on two 96x96 videos of 5 frames (NIQE needs a 96x96
    block): --grids with one crop in one transform, NIQE and PSNR from the
    registry, a Chrome trace.  The Evaluator builds the variant narrow (its
    ``build_model`` given narrow widths, the weights saved at them), so the
    test stays light beside the other CPU suites."""
    monkeypatch.setattr(runner, 'build_model',
                        functools.partial(build_model, **TINY))
    data = tmp_path / 'data'
    if variant.startswith('deblur'):
        write_frames({'blur': data / 'blur', 'gt': data / 'gt'},
                     ('clip1', 'clip2'), 5, 96, 96, 23)
        main, extra = test_deblur.main, ['--one_len', '1', '--fp32']
    else:
        write_frames({'gt': data}, ('clip1', 'clip2'), 5, 96, 96, 23)
        main, extra = test_denoise.main, ['--sigma', '10', '--no_tile']
    prof = tmp_path / 'prof'
    main(['--variant', variant,
          '--model_path', state_npz(variant, tmp_path / 'net.npz',
                                    **TINY),
          '--data_path', str(data), '--result_path', str(tmp_path / 'out'),
          '--device', 'cpu', '--grids',
          '--trans_num', '1', '--metric', 'niqe=calculate_niqe',
          '--metric', 'psnr=calculate_psnr', '--profile', str(prof),
          *extra])
    out = capsys.readouterr().out
    for video in ('clip1', 'clip2'):
        assert f'> {video}-00000 NIQE=' in out
        assert f'# Video:{video} AVG-NIQE=' in out
    assert '# Total AVG-NIQE=' in out and 'AVG-PSNR=' in out
    assert 'AVG-SSIM' not in out
    assert '1 crops of 96x96 x 1 transforms' in out
    res = eval(out.strip().splitlines()[-1])
    assert res['n_frames'] == 2 and np.isfinite(res['niqe'])
    assert read_trace(prof)['traceEvents']


def test_parse_metric_args_matches_jax():
    from shiftnet_tpu.tools.test_denoise import (
        parse_metric_args as jax_parse)
    for entries in (None, [], ['niqe=calculate_niqe', 'psnr'],
                    ['y=calculate_psnr']):
        assert test_denoise.parse_metric_args(entries) == jax_parse(entries)


def test_trace_and_phase_timer(tmp_path):
    with trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path / 'prof')):
        torch.ones(8).add_(1)
    assert any('add_' in e.get('name', '')
               for e in read_trace(tmp_path / 'prof')['traceEvents'])
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase('fwd'):
            pass
    with timer.phase('post'):
        pass
    assert list(timer.totals) == ['fwd', 'post']
    assert timer.summary().startswith('fwd:') and 'post:' in timer.summary()


# -- the drift tool --------------------------------------------------------------

def root_drift_tool():
    spec = importlib.util.spec_from_file_location(
        'root_measure_drift', REPO / 'tools' / 'measure_drift.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_drift_synth_clip_matches_root_tool():
    root = root_drift_tool()
    for args in ((3, 24, 40), (2, 17, 31)):
        np.testing.assert_array_equal(measure_drift.synth_clip(*args),
                                      root.synth_clip(*args))
    assert measure_drift.psnr(np.zeros(4), np.full(4, 2.0)) == root.psnr(
        np.zeros(4), np.full(4, 2.0))


@pytest.mark.parametrize('variant', ['deblur_small', 'denoise_small'])
def test_drift_legs_on_the_cpu(variant):
    state = measure_drift.perturb_betas(init_state(
        build_model(variant, **TINY), seed=0))
    betas = [v for k, v in state.items() if k.endswith('.beta')]
    assert betas and all(bool((b == 0.1).all()) for b in betas)
    torch.backends.cudnn.allow_tf32 = True
    res = measure_drift.run(variant, 1, 32, 48, split=True, device='cpu',
                            overrides=TINY)
    assert torch.backends.cudnn.allow_tf32  # off only while it runs
    assert list(res['legs']) == ['bf16-fused', 'f32-plain', 'bf16-plain']
    for leg in res['legs'].values():
        assert leg['peak'] is None and leg['out'].shape == (1, 32, 48, 3)
    for key in ('db', 'path_db', 'dtype_db'):
        assert 30 < res[key] < 100, (key, res[key])
