"""The port's evaluation harness: ``Evaluator.forward_window`` against the
JAX model's forward, the deblur CLI end to end, the port's own window and
metric helpers against the JAX package's, and the port's freedom from JAX
and from the JAX package, on the CPU.
"""
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from shiftnet_tpu.data.video_dataset import _imread as jax_imread
from shiftnet_tpu.eval import metrics as jmetrics
from shiftnet_tpu.eval import registry as jregistry
from shiftnet_tpu.eval import window as jwindow
from shiftnet_tpu.eval.window import half_slices
from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from shiftnet_tpu_torch.eval import metrics, registry, window
from shiftnet_tpu_torch.eval.runner import (CONFIG_OVERRIDES, METRICS,
                                            WINDOW_BYTES_PER_PX, Evaluator,
                                            _imread, configuration)
from shiftnet_tpu_torch.models import build_model, init_state

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices('cpu')[0]
TINY = dict(n_feats0=8, n_feats2=48, num_orbs=1, tfr_scale=4, shift_rounds=2)
HALO = 2


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


@pytest.fixture(scope='module')
def tiny():
    """(port state, jitted JAX forward on the same weights)."""
    state = init_state(build_model('deblur_plus', **TINY), seed=11)
    jmodel = jax_build_model('deblur_plus', past_frames=HALO,
                             future_frames=HALO, **TINY)
    tpl = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2 * HALO + 1, 32, 32, 3))))
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl['params'])
    fwd = jax.jit(lambda v: jmodel.apply({'params': params}, v))
    return state, lambda x: np.asarray(fwd(jnp.asarray(x)))


def clip(t, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (t, h, w, 3)).astype(
        np.float32)


def evaluator(state, tmp_path):
    return Evaluator('deblur_plus', state, device='cpu', bf16=False,
                     overrides=TINY, result_path=str(tmp_path))


def test_forward_window_full_plan_matches_jax(tiny, tmp_path):
    state, jax_fwd = tiny
    x = clip(6, 80, 32, 12)
    ev = evaluator(state, tmp_path)
    assert ev.window_plan(x.shape) == 'full'
    got = ev.forward_window(x)
    assert got.shape == (6 - 2 * HALO, 80, 32, 3) and got.dtype == np.float32
    assert norm_err(got, jax_fwd(x)) < 1e-4


def test_evaluator_defaults_to_fused_chw(tiny, tmp_path):
    state, _ = tiny
    ev = evaluator(state, tmp_path)
    assert ev.model.cfg.fused_chw and ev.dtype == torch.float32
    assert ev.bytes_per_px == WINDOW_BYTES_PER_PX[
        ('deblur_plus', 'fused_chw', torch.float32)]
    for name, overrides in CONFIG_OVERRIDES.items():
        cfg = build_model('deblur_plus', **TINY, **overrides).cfg
        assert configuration(cfg) == name


def test_forward_window_half_plan_matches_jax_tiles(tiny, tmp_path,
                                                   monkeypatch):
    state, jax_fwd = tiny
    x = clip(6, 96, 32, 13)  # half_slices: two 80-row tiles
    ev = evaluator(state, tmp_path)
    monkeypatch.setattr(ev, '_budget', lambda: 1)  # a one-byte device
    assert ev.window_plan(x.shape) == 'half'
    got = ev.forward_window(x)
    want = np.zeros_like(got)
    for in_sl, crop_sl, out_sl in half_slices(96, 32):
        o = jax_fwd(x[:, in_sl[0], in_sl[1]])
        want[:, out_sl[0], out_sl[1]] = o[:, crop_sl[0], crop_sl[1]]
    assert norm_err(got, want) < 1e-4
    log = Path(ev.logger.path).read_text()
    assert '-> half' in log


def test_deblur_cli_logs_psnr_ssim(tmp_path, capsys, monkeypatch):
    """The deblur CLI end to end on two synthetic videos: it logs PSNR and
    SSIM per chunk, per video and in total.  It runs in this process, and
    the Evaluator builds deblur_plus narrow (its ``build_model`` given
    ``TINY``, the weights saved at those widths), as
    ``tests/test_torch_validation.py`` does, so that it stays light beside
    the other CPU suites."""
    from shiftnet_tpu_torch.eval import runner
    from shiftnet_tpu_torch.tools import test_deblur
    monkeypatch.setattr(runner, 'build_model',
                        functools.partial(build_model, **TINY))
    rng = np.random.default_rng(14)
    data = tmp_path / 'data'
    for video in ('clip1', 'clip2'):
        base = rng.integers(0, 255, (32, 32, 3))
        for sub in ('blur', 'gt'):
            d = data / sub / video
            d.mkdir(parents=True)
            for i in range(6):
                noise = rng.integers(-8, 8, (32, 32, 3))
                img = np.clip(base + noise, 0, 255).astype(np.uint8)
                Image.fromarray(img).save(d / f'{i:03d}.png')
    state = init_state(build_model('deblur_plus', **TINY), seed=15)
    npz = tmp_path / 'net.npz'
    np.savez(npz, **{k: v.numpy() for k, v in state.items()})
    test_deblur.main(['--model_path', str(npz), '--data_path', str(data),
                      '--result_path', str(tmp_path / 'out'), '--one_len',
                      '2', '--fp32', '--device', 'cpu'])
    out = capsys.readouterr().out
    for video in ('clip1', 'clip2'):
        assert f'> {video}-00000 PSNR=' in out
        assert f'# Video:{video} AVG-PSNR=' in out
    assert '# Total AVG-PSNR=' in out and 'AVG-SSIM=' in out
    logs = list((tmp_path / 'out').glob('inference_log_*.txt'))
    assert logs and 'AVG-SSIM=' in logs[0].read_text()


def test_port_imports_no_jax():
    """Every port module (the probe tools and ``ops/probes`` among them) and
    chip_smoke import with JAX, flax, the JAX package and the JAX package's
    root ``tools/`` all blocked, every variant builds and its prep_naf runs,
    and no module of the JAX package is left loaded."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['shiftnet_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "import importlib, pkgutil\n"
        "import shiftnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    shiftnet_tpu_torch.__path__, 'shiftnet_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "import torch\n"
        "from shiftnet_tpu_torch.models import CONFIGS, build_model\n"
        "from shiftnet_tpu_torch.ops import naf_chw\n"
        "for v in CONFIGS:\n"
        "    m = build_model(v, fused_chw=True)\n"
        "    blk = m.stage1.decoder_level1.encoder_level1_1\n"
        "    naf_chw.prep_naf(dict(blk.named_parameters()), '0',\n"
        "                     torch.float32, mid_ca=m.cfg.cab_mid_ca,\n"
        "                     last_bias=m.cfg.cab_last_bias)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None and\n"
        "          (k in ('shiftnet_tpu', 'tools')\n"
        "           or k.startswith(('shiftnet_tpu.', 'tools.')))]\n"
        "assert not loaded, loaded\n"
        "assert 'shiftnet_tpu_torch.ops.probes' in sys.modules\n"
        "assert 'shiftnet_tpu_torch.tools.probe_copy_bw' in sys.modules\n"
        "for n in ('train.trainer', 'train.optim', 'ops.chw_grad',\n"
        "          'data.packed', 'data.loader', 'tools.train',\n"
        "          'parallel.mesh', 'parallel.temporal', 'parallel.launch',\n"
        "          'parallel.workers', 'tools.bench_train',\n"
        "          'tools.profile_train'):\n"
        "    assert 'shiftnet_tpu_torch.' + n in sys.modules, n\n"
        "from shiftnet_tpu_torch.data import packed\n"
        "lib = packed._load_lib()\n"
        "assert lib is not None and packed.library_path().parent == \\\n"
        "    packed.BUILD_DIR and lib._name == str(packed.library_path())\n"
        "assert packed.SOURCE.parent.parent.name == 'shiftnet_tpu_torch'\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, 'PYTHONPATH': str(REPO)})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


IMPORT_OF_JAX_PACKAGE = re.compile(
    r'^\s*(import|from)\s+(shiftnet_tpu(?!_torch)|tools)\b', re.MULTILINE)


def test_port_sources_import_nothing_of_the_jax_package():
    """No ``import shiftnet_tpu`` / ``from shiftnet_tpu`` (other than
    ``shiftnet_tpu_torch``) and no import of the root ``tools/`` in any
    source of the port or in chip_smoke; the port's C++ reader includes
    nothing of the repo and names the port's module as its caller."""
    sources = sorted((REPO / 'shiftnet_tpu_torch').rglob('*.py'))
    sources.append(REPO / 'chip_smoke.py')
    assert len(sources) >= 20
    assert {f'shiftnet_tpu_torch/{m}.py' for m in (
        'parallel/mesh', 'parallel/temporal', 'parallel/launch',
        'parallel/workers', 'tools/bench_train', 'tools/profile_train')} <= {
        str(p.relative_to(REPO)) for p in sources}
    found = [f'{path.relative_to(REPO)}: {m.group(0).strip()}'
             for path in sources
             for m in IMPORT_OF_JAX_PACKAGE.finditer(path.read_text())]
    assert not found, found
    cpp = (REPO / 'shiftnet_tpu_torch' / 'native' / 'packed_reader.cpp'
           ).read_text()
    assert all(line.split()[1].startswith('<')
               for line in cpp.splitlines() if line.startswith('#include'))
    assert 'shiftnet_tpu_torch/data/packed.py' in cpp
    assert not re.search(r'shiftnet_tpu/', cpp)
    assert IMPORT_OF_JAX_PACKAGE.search('from shiftnet_tpu.eval import x')
    assert IMPORT_OF_JAX_PACKAGE.search('    import shiftnet_tpu\n')
    assert not IMPORT_OF_JAX_PACKAGE.search('from shiftnet_tpu_torch import x')
    assert IMPORT_OF_JAX_PACKAGE.search('from tools import probe_copy_bw')
    assert IMPORT_OF_JAX_PACKAGE.search('import tools.microbench_mm')
    assert not IMPORT_OF_JAX_PACKAGE.search(
        'from shiftnet_tpu_torch.tools import probe_chw')


@pytest.mark.parametrize('n_frames,one_len', [(40, 36), (100, 36), (7, 2),
                                              (4, 1)])
def test_port_window_plans_match_jax(n_frames, one_len):
    assert ([tuple(vars(c).values())
             for c in window.plan_deblur_chunks(n_frames, one_len, 2)]
            == [tuple(vars(c).values())
                for c in jwindow.plan_deblur_chunks(n_frames, one_len, 2)])
    h, w = 8 * n_frames, 12 * one_len
    assert window.half_slices(h, w) == jwindow.half_slices(h, w)
    img = np.random.default_rng(n_frames).integers(
        0, 255, (3, h + 3, w + 2, 3)).astype(np.uint8)
    np.testing.assert_array_equal(window.mod_crop(img, 4),
                                  jwindow.mod_crop(img, 4))


@pytest.mark.parametrize('name,shape', [('rgb.png', (20, 30, 3)),
                                        ('grey.png', (20, 30)),
                                        ('rgba.png', (20, 30, 4)),
                                        ('rgb.jpg', (20, 30, 3))])
def test_port_imread_matches_jax(tmp_path, name, shape):
    """The port reads frames with Pillow (the GPU machine has no imageio);
    the JAX package with imageio.  Both give the same RGB uint8 pixels."""
    imageio = pytest.importorskip('imageio.v2')
    img = np.random.default_rng(17).integers(0, 255, shape).astype(np.uint8)
    path = tmp_path / name
    imageio.imwrite(path, img)
    got = _imread(str(path))
    assert got.dtype == np.uint8 and got.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, jax_imread(str(path)))


def test_port_metrics_match_jax():
    rng = np.random.default_rng(16)
    gt = rng.integers(0, 255, (24, 40, 3)).astype(np.float32)
    img = np.clip(gt + rng.normal(0, 9, gt.shape), 0, 255)
    assert metrics.psnr(img, gt) == jmetrics.psnr(img, gt)
    assert metrics.ssim(img, gt) == jmetrics.ssim(img, gt)
    assert metrics.psnr(gt, gt) == float('inf')
    assert (registry.score_pair(img, gt, METRICS)
            == jregistry.score_pair(img, gt, METRICS))
