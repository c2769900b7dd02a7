"""The port's small variants, deblur_small ("Ours-s") and denoise_small,
against the reference fixtures and the JAX package, on the CPU in float32:
the reference keys, the published-width models, a narrow model in every
configuration with ``conv_concat`` off and on, the layers the small
variants add (depthwise RepConv, CALayer with reduction 1), the weights
carried from JAX, and ``eval_deblur`` / ``eval_denoise`` against the JAX
Evaluator's.

One JAX Evaluator per variant (unfused, narrow widths, 2+2 halo) serves
every JAX forward here at one window shape, so each variant's jit compile
is paid once.
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
from shiftnet_tpu.eval.runner import Evaluator as JaxEvaluator
from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.models import layers as jl
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from test_torch_denoise import write_videos
from test_torch_model import reference_state
from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator
from shiftnet_tpu_torch.models import CONFIGS, build_model, init_state, layers
from shiftnet_tpu_torch.ops import chw
from shiftnet_tpu_torch.tools.convert import state_from_jax
from shiftnet_tpu_torch.tools.params_io import drop_unused_reference_keys

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices('cpu')[0]
SMALL = ('deblur_small', 'denoise_small')
# Narrow widths, one orb, two shift rounds; n_feats2=32 gives 2 channels per
# shift group number and a depthwise RepConv of 32 channels.
TINY = dict(n_feats0=8, n_feats2=32, num_orbs=1, shift_rounds=2)
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
    """variant -> (port state, JAX params on the same weights, a float32 JAX
    Evaluator on them, a (T, H, W) clip, its JAX forward), built once per
    variant."""
    made = {}

    def get(variant):
        if variant not in made:
            made[variant] = make_tiny(variant, tmp_path_factory)
        return made[variant]
    return get


def make_tiny(variant, tmp_path_factory):
    noise = CONFIGS[variant].noise_map
    state = init_state(build_model(variant, **TINY), seed=31)
    jmodel = jax_build_model(variant, past_frames=HALO, future_frames=HALO,
                             **TINY)
    args = (jnp.zeros((T, H, W, 3)),) + (
        (jnp.zeros((T, H, W, 1)),) if noise else ())
    tpl = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), *args))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    jev = JaxEvaluator(variant, params, bf16=False,
                       result_path=str(tmp_path_factory.mktemp('jax_eval')),
                       overrides={'fused_chw': False, **TINY})
    x = clip(T, H, W, 32)
    return state, params, jev, x, jax_forward(jev, x)


def jax_forward(jev, x):
    """The JAX Evaluator's compiled forward of one window (or quadrant
    tile)."""
    xt = jnp.asarray(x)
    if jev.cfg.noise_map:
        nm = jnp.full(xt.shape[:3] + (1,), SIGMA, jnp.float32)
        return np.asarray(jev._forward(xt.shape)(jev.params, xt, nm))
    return np.asarray(jev._forward(xt.shape)(jev.params, xt))


def port_forward(model, x, variant):
    nm = (torch.full((x.shape[0], 1) + x.shape[1:3], SIGMA)
          if CONFIGS[variant].noise_map else None)
    with torch.inference_mode():
        return model(nchw(x), nm).permute(0, 2, 3, 1).numpy()


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize('variant', SMALL)
def test_small_keys_are_the_reference_keys(variant):
    """The reference keys minus the extra orbs the small variants build and
    never run (orb4/5, rorb4/5) and the one unused PReLU: ``lrelu`` in
    deblur_small, ``stage1.act`` (the add-fuse PReLU) in denoise_small."""
    fx = load_fixture(f'model_{variant}')
    torch_keys = set(str(fx['torch_keys']).split('\n'))
    ours = set(build_model(variant).state_dict())
    unused = {'deblur_small': 'lrelu.weight',
              'denoise_small': 'stage1.act.weight'}[variant]
    extra_orbs = {k for k in torch_keys
                  if k.startswith(('orb4.', 'orb5.', 'rorb4.', 'rorb5.'))}
    assert extra_orbs
    assert ours == torch_keys - extra_orbs - {unused}
    assert set(drop_unused_reference_keys(
        dict.fromkeys(torch_keys), variant)) == ours


@pytest.mark.parametrize('config', ['plain', 'fused_chw'])
@pytest.mark.parametrize('variant', SMALL)
def test_small_matches_reference_output(variant, config):
    """The published widths (n_feats0 14, n_feats2 64, 3+3 TFR U-Nets,
    2-level Encoder2 with 4-round shift blocks) on the fixture generator's
    weights, loaded with strict=True."""
    fx = load_fixture(f'model_{variant}')
    model = build_model(variant, **CONFIG_OVERRIDES[config])
    model.load_state_dict(reference_state(model), strict=True)
    nm = (torch.from_numpy(fx['noise_map'][0])
          if CONFIGS[variant].noise_map else None)
    with torch.inference_mode():
        out = model(torch.from_numpy(fx['x'][0]), nm).numpy()
    want = fx['out']
    tol = max(5e-4, 5.0 * float(fx['self_err']))
    assert out.shape == want.shape
    assert norm_err(out, want) < tol


@pytest.mark.parametrize('conv_concat', [False, True])
@pytest.mark.parametrize('config', ['plain', 'fused_tfr', 'fused_chw'])
@pytest.mark.parametrize('variant', SMALL)
def test_tiny_forward_matches_jax_unfused(tiny, variant, config,
                                          conv_concat):
    """Every configuration, with conv_concat off and on (it acts on the
    fused_chw path only, as in JAX), against the JAX unfused forward; no
    kernel launches on the CPU and the input is left unwritten."""
    state, _, _, x, want = tiny(variant)
    overrides = dict(CONFIG_OVERRIDES[config], conv_concat=conv_concat)
    model = build_model(variant, past_frames=HALO, future_frames=HALO,
                        **TINY, **overrides)
    model.load_state_dict(state, strict=True)
    xt = nchw(x)
    x0 = xt.clone()
    nm = (torch.full((T, 1, H, W), SIGMA) if CONFIGS[variant].noise_map
          else None)
    chw.reset_launches()
    with torch.inference_mode():
        got = model(xt, nm)
    assert set(chw.LAUNCHES.values()) == {0}
    assert torch.equal(xt, x0)
    assert got.shape == (T - 2 * HALO, 3, H, W)
    assert norm_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4


@pytest.mark.parametrize('variant', SMALL)
def test_state_from_jax_round_trips_exactly(tiny, variant):
    state, params, _, x, want = tiny(variant)
    back = state_from_jax(jax.tree.map(np.asarray, params))
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    model = build_model(variant, past_frames=HALO, future_frames=HALO,
                        **TINY)
    model.load_state_dict(back, strict=True)
    assert norm_err(port_forward(model, x, variant), want) < 1e-4


# -- the layers the small variants add -----------------------------------------

def flax_apply(fmod, state, *xs):
    """Apply a flax module on the port module's weights (NCHW numpy in and
    out)."""
    args = [jnp.asarray(np.transpose(x, (0, 2, 3, 1))) for x in xs]
    tpl = jax.eval_shape(
        lambda: fmod.init(jax.random.PRNGKey(0), *args))['params']
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    return np.transpose(np.asarray(fmod.apply({'params': params}, *args)),
                        (0, 3, 1, 2))


@pytest.mark.parametrize('kind', ['repconv_depthwise', 'calayer_r1'])
def test_small_layers_match_flax(kind):
    c = 32
    x = np.random.default_rng(33).standard_normal((2, c, 11, 13)).astype(
        np.float32)
    if kind == 'repconv_depthwise':
        mod = layers.RepConv(c, 5, depthwise=True)
        fmod = jl.RepConv(c, 5, depthwise=True)
    else:  # deblur_small's CALayer: a c -> c -> c MLP
        mod = layers.CALayer(c, 1)
        fmod = jl.CALayer(c, 1)
    state = init_state(mod, 34)
    mod.load_state_dict(state, strict=True)
    if kind == 'repconv_depthwise':
        assert mod.conv_1.weight.shape == (c, 1, 5, 5)
    else:
        assert mod.conv_du[0].weight.shape == (c, c, 1, 1)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert norm_err(got, flax_apply(fmod, state, x)) < 1e-5


# -- evaluation ----------------------------------------------------------------

@pytest.mark.parametrize('variant', SMALL)
def test_evaluator_defaults(variant, tmp_path):
    """The JAX Evaluator's defaults: fused_chw, conv_concat off, bf16 for
    deblur_small and float32 for denoise_small."""
    state = init_state(build_model(variant, **TINY), seed=35)
    ev = Evaluator(variant, state, device='cpu', overrides=TINY,
                   result_path=str(tmp_path))
    assert ev.model.cfg.fused_chw and not ev.model.cfg.conv_concat
    assert ev.dtype == (torch.float32 if variant == 'denoise_small'
                        else torch.bfloat16)
    assert ev.window_plan((T, H, W, 3)) == 'full'
    # a DAVIS-width frame (852 = 4 mod 8) takes the quadrant plan
    assert ev.window_plan((16, 480, 852, 3)) == 'quadrant'


def test_eval_deblur_small_matches_jax_evaluator(tiny, tmp_path):
    variant = 'deblur_small'
    state, _, jev, _, _ = tiny(variant)
    data = tmp_path / 'data'
    for sub, seed in (('blur', 36), ('gt', 37)):
        write_videos(data / sub, 1, T, H, W, seed)
    ev = Evaluator(variant, state, device='cpu', bf16=False, overrides=TINY,
                   result_path=str(tmp_path / 'out'))
    got = ev.eval_deblur(str(data), one_len=2)
    want = jev.eval_deblur(str(data), one_len=2)
    assert got['n_frames'] == want['n_frames'] == 2
    assert abs(got['psnr'] - want['psnr']) < 1e-3
    assert abs(got['ssim'] - want['ssim']) < 1e-5


def test_eval_denoise_small_matches_jax_evaluator(tiny, tmp_path):
    """The same seed gives both packages the same noisy clips.  (The
    quadrant plan that a DAVIS-width frame takes is shared with
    denoise_plus and held against the JAX quadrant path in
    test_torch_denoise.py.)"""
    variant = 'denoise_small'
    state, _, jev, _, _ = tiny(variant)
    data = tmp_path / 'data'
    write_videos(data, 1, T, H, W, 38)
    ev = Evaluator(variant, state, device='cpu', overrides=TINY,
                   result_path=str(tmp_path / 'out'))
    got = ev.eval_denoise(str(data), 10.0, seed=5)
    want = jev.eval_denoise(str(data), 10.0, seed=5)
    assert got['n_frames'] == want['n_frames'] == T - 2 * HALO
    for key in ('psnr', 'psnr_video_avg'):
        assert abs(got[key] - want[key]) < 1e-3
    for key in ('ssim', 'ssim_video_avg'):
        assert abs(got[key] - want[key]) < 1e-5
    assert '-> full' in Path(ev.logger.path).read_text()


def test_deblur_small_cli_logs_psnr_ssim(tmp_path):
    data = tmp_path / 'data'
    for sub, seed in (('blur', 39), ('gt', 40)):
        write_videos(data / sub, 1, 6, 48, 48, seed)
    state = init_state(build_model('deblur_small'), seed=41)
    npz = tmp_path / 'net.npz'
    np.savez(npz, **{k: v.numpy() for k, v in state.items()})
    res = subprocess.run(
        [sys.executable, '-m', 'shiftnet_tpu_torch.tools.test_deblur',
         '--variant', 'deblur_small', '--model_path', str(npz),
         '--data_path', str(data), '--one_len', '2', '--fp32',
         '--result_path', str(tmp_path / 'out'), '--device', 'cpu'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'PYTHONPATH': str(REPO)})
    assert res.returncode == 0, res.stderr
    assert '> clip0-00000 PSNR=' in res.stdout
    assert '# Total AVG-PSNR=' in res.stdout and 'AVG-SSIM=' in res.stdout
