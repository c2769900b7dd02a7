"""The port's denoise_plus path against the reference fixture and the JAX
package, on the CPU in float32: the ShiftCAB, the narrow model in every
configuration with ``conv_concat`` off and on, the window plans, the
quadrant plan of frames whose width is not a multiple of 8, and
``eval_denoise`` against the JAX Evaluator's.

One JAX Evaluator (unfused, narrow widths, 2+2 halo) serves every JAX
forward here at one window shape, so its jit compile is paid once.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from shiftnet_tpu.eval import window as jwindow
from shiftnet_tpu.eval.runner import Evaluator as JaxEvaluator
from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.models import layers as jl
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from test_torch_model import reference_state
from shiftnet_tpu_torch.eval import window
from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator
from shiftnet_tpu_torch.models import build_model, init_state, layers
from shiftnet_tpu_torch.ops import chw
from shiftnet_tpu_torch.tools.convert import state_from_jax
from shiftnet_tpu_torch.tools.params_io import drop_unused_reference_keys

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices('cpu')[0]
TINY = dict(n_feats0=8, n_feats2=48, num_orbs=1, tfr_scale=4, shift_rounds=2)
HALO = 2
SIGMA = 10.0 / 255.0
# The one JAX window shape: the quadrant tile of a 64x100 frame is 64x80.
T, H, W = 2 * HALO + 2, 64, 80


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


def clip(t, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (t, h, w, 3)).astype(
        np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1,
                                                                  2))))


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """(port state, JAX params on the same weights, a JAX Evaluator on them,
    its forward of one (T, H, W) clip at sigma 10/255, that clip)."""
    state = init_state(build_model('denoise_plus', **TINY), seed=21)
    jmodel = jax_build_model('denoise_plus', past_frames=HALO,
                             future_frames=HALO, **TINY)
    tpl = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)),
        jnp.zeros((T, H, W, 1))))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    jev = JaxEvaluator('denoise_plus', params,
                       result_path=str(tmp_path_factory.mktemp('jax_eval')),
                       overrides={'fused_chw': False, **TINY})
    x = clip(T, H, W, 22)
    return state, params, jev, x, jax_forward(jev, x)


def jax_forward(jev, x):
    """The JAX Evaluator's compiled forward of one tile, as its quadrant
    path (``eval_denoise(tile=True)``) runs it."""
    xt = jnp.asarray(x)
    nm = jnp.full(xt.shape[:3] + (1,), SIGMA, jnp.float32)
    return np.asarray(jev._forward(xt.shape)(jev.params, xt, nm))


# -- the model -----------------------------------------------------------------

def test_denoise_plus_keys_are_the_reference_keys():
    fx = load_fixture('model_denoise_plus')
    torch_keys = set(str(fx['torch_keys']).split('\n'))
    ours = set(build_model('denoise_plus').state_dict())
    # stage1.act is registered but unused by the reference
    # (test_model_parity.py:101-109); lrelu is used by the denoise variants
    assert torch_keys - ours == {'stage1.act.weight'}
    assert ours <= torch_keys
    assert set(drop_unused_reference_keys(
        dict.fromkeys(torch_keys), 'denoise_plus')) == ours


@pytest.mark.parametrize('config', ['plain', 'fused_chw'])
def test_denoise_plus_matches_reference_output(config):
    fx = load_fixture('model_denoise_plus')
    model = build_model('denoise_plus', **CONFIG_OVERRIDES[config])
    model.load_state_dict(reference_state(model), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(fx['x'][0]),
                    torch.from_numpy(fx['noise_map'][0])).numpy()
    want = fx['out']
    tol = max(5e-4, 5.0 * float(fx['self_err']))
    assert out.shape == want.shape
    assert norm_err(out, want) < tol


@pytest.mark.parametrize('conv_concat', [False, True])
@pytest.mark.parametrize('config', ['plain', 'fused_tfr', 'fused_chw'])
def test_tiny_forward_matches_jax_unfused(tiny, config, conv_concat):
    """Every configuration, with conv_concat off and on (it acts on the
    fused_chw path only, as in JAX), against the JAX unfused forward; no
    kernel launches on the CPU and the input is left unwritten."""
    state, _, _, x, want = tiny
    overrides = dict(CONFIG_OVERRIDES[config], conv_concat=conv_concat)
    model = build_model('denoise_plus', past_frames=HALO, future_frames=HALO,
                        **TINY, **overrides)
    model.load_state_dict(state, strict=True)
    xt = nchw(x)
    x0 = xt.clone()
    nm = torch.full((T, 1, H, W), SIGMA)
    chw.reset_launches()
    with torch.inference_mode():
        got = model(xt, nm)
    assert set(chw.LAUNCHES.values()) == {0}
    assert torch.equal(xt, x0)
    assert got.shape == (T - 2 * HALO, 3, H, W)
    assert norm_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4


def test_jax_params_convert_load_and_compute_the_same(tiny):
    state, params, _, x, want = tiny
    back = state_from_jax(jax.tree.map(np.asarray, params))
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    model = build_model('denoise_plus', past_frames=HALO, future_frames=HALO,
                        **TINY)
    model.load_state_dict(back, strict=True)
    with torch.inference_mode():
        got = model(nchw(x), torch.full((T, 1, H, W), SIGMA))
    assert norm_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4


def test_noise_map_is_required():
    model = build_model('denoise_plus', **TINY)
    with pytest.raises(ValueError, match='noise map'):
        model(torch.zeros(5, 3, 32, 32))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('reverse', [False, True])
def test_shift_cab_matches_flax(fused, reverse):
    t, c, h, w = 4, 16, 12, 20
    x = np.random.default_rng(23).standard_normal((t, c, h, w)).astype(
        np.float32)
    mod = layers.ShiftCAB(c, 3, 4, reverse=reverse, fused=fused)
    state = init_state(mod, 24)
    mod.load_state_dict(state, strict=True)
    assert set(state) == {'body.0.weight', 'body.1.weight', 'body.2.weight',
                          'CA.conv_du.0.weight', 'CA.conv_du.2.weight'}
    xt = torch.from_numpy(x.copy())
    with torch.no_grad():
        got = mod(xt, inplace=True)
    np.testing.assert_array_equal(xt.numpy(), x)  # the input is not written
    fmod = jl.ShiftCAB(c, 3, 4, reverse=reverse)
    xn = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    tpl = jax.eval_shape(
        lambda: fmod.init(jax.random.PRNGKey(0), xn))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    want = np.transpose(np.asarray(fmod.apply({'params': params}, xn)),
                        (0, 3, 1, 2))
    assert norm_err(got.numpy(), want) < 1e-5


# -- evaluation ----------------------------------------------------------------

@pytest.mark.parametrize('n_frames', [5, 16, 54, 104, 105, 205])
def test_port_denoise_plans_match_jax(n_frames):
    assert ([tuple(vars(c).values())
             for c in window.plan_denoise_chunks(n_frames, HALO)]
            == [tuple(vars(c).values())
                for c in jwindow.plan_denoise_chunks(n_frames, HALO)])
    for h, w in ((480, 852), (64, 100), (720, 1280), (8 * n_frames,
                                                     4 * n_frames + 48)):
        assert window.quadrant_pads(h, w) == jwindow.quadrant_pads(h, w)
        assert window.quadrant_slices(h, w) == jwindow.quadrant_slices(h, w)


def port_evaluator(state, tmp_path, **kw):
    return Evaluator('denoise_plus', state, device='cpu', overrides=TINY,
                     result_path=str(tmp_path), **kw)


def test_evaluator_defaults_to_float32_fused_chw(tiny, tmp_path):
    ev = port_evaluator(tiny[0], tmp_path)
    assert ev.dtype == torch.float32 and ev.noise_map
    assert ev.model.cfg.fused_chw and not ev.model.cfg.conv_concat
    with pytest.raises(ValueError, match='sigma'):
        ev.forward_window(clip(T, H, W, 25))
    # too small for the quadrant tiles, and not a multiple of 8
    with pytest.raises(ValueError, match='quadrant'):
        ev.window_plan((T, 32, 36, 3))
    assert ev.window_plan((T, H, W, 3)) == 'full'
    assert ev.window_plan((T, H, W, 3), quadrant=True) == 'quadrant'


def test_width_4_mod_8_takes_the_quadrant_plan(tiny, tmp_path):
    """A 64x100 window never reaches the model at that width: it goes as
    the reference's four 64x80 quadrant tiles, and gives what the JAX
    Evaluator's quadrant path (``eval_denoise(tile=True)``) gives."""
    state, _, jev, _, _ = tiny
    x = clip(T, 64, 100, 26)
    ev = port_evaluator(state, tmp_path)
    assert ev.window_plan(x.shape) == 'quadrant'
    seen = []
    ev.model.register_forward_pre_hook(
        lambda _m, args: seen.append(tuple(args[0].shape)))
    got = ev.forward_window(x, SIGMA)
    assert seen and all(s[2] % 8 == 0 and s[3] % 8 == 0 for s in seen)
    want = np.zeros_like(got)
    for in_sl, crop_sl, out_sl in jwindow.quadrant_slices(64, 100):
        o = jax_forward(jev, x[:, in_sl[0], in_sl[1]])
        want[:, out_sl[0], out_sl[1]] = o[:, crop_sl[0], crop_sl[1]]
    assert norm_err(got, want) < 1e-4
    assert '-> quadrant' in Path(ev.logger.path).read_text()


def write_videos(root, n_videos, t, h, w, seed):
    imageio = pytest.importorskip('imageio.v2')
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = root / f'clip{v}'
        d.mkdir(parents=True)
        base = rng.integers(0, 255, (h, w, 3))
        for i in range(t):
            img = np.clip(base + rng.integers(-8, 8, (h, w, 3)), 0, 255)
            imageio.imwrite(d / f'{i:03d}.png', img.astype(np.uint8))


def test_eval_denoise_matches_jax_evaluator(tiny, tmp_path):
    """The same seed gives both packages the same noisy clips; the port's
    default plan on 64x100 frames is the JAX Evaluator's forced quadrant
    tiling."""
    state, _, jev, _, _ = tiny
    data = tmp_path / 'data'
    write_videos(data, 2, T, 64, 100, 27)
    ev = port_evaluator(state, tmp_path / 'out')
    got = ev.eval_denoise(str(data), 10.0, seed=5)
    want = jev.eval_denoise(str(data), 10.0, tile=True, seed=5)
    assert got['n_frames'] == want['n_frames'] == 2 * (T - 2 * HALO)
    for key in ('psnr', 'psnr_video_avg'):
        assert abs(got[key] - want[key]) < 1e-3
    for key in ('ssim', 'ssim_video_avg'):
        assert abs(got[key] - want[key]) < 1e-5
    log = Path(ev.logger.path).read_text()
    assert log.count('# Total AVG-PSNR=') == 2  # frame and video averages


def test_denoise_cli_logs_psnr_ssim(tmp_path):
    data = tmp_path / 'data'
    write_videos(data, 2, 5, 48, 48, 28)
    state = init_state(build_model('denoise_plus'), seed=29)
    npz = tmp_path / 'net.npz'
    np.savez(npz, **{k: v.numpy() for k, v in state.items()})
    res = subprocess.run(
        [sys.executable, '-m', 'shiftnet_tpu_torch.tools.test_denoise',
         '--model_path', str(npz), '--data_path', str(data), '--sigma', '15',
         '--result_path', str(tmp_path / 'out'), '--device', 'cpu'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'PYTHONPATH': str(REPO)})
    assert res.returncode == 0, res.stderr
    for video in ('clip0', 'clip1'):
        assert f'> {video}-00000 PSNR=' in res.stdout
        assert f'# Video:{video} AVG-PSNR=' in res.stdout
    assert '# Total AVG-PSNR=' in res.stdout and 'AVG-SSIM=' in res.stdout
    assert "'psnr_video_avg'" in res.stdout
    logs = list((tmp_path / 'out').glob('inference_log_*.txt'))
    assert logs and 'AVG-SSIM=' in logs[0].read_text()
