"""The port's GShiftNet against the reference fixture and the JAX package's
unfused forward, on the CPU in float32, and the weights carried between
the two packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from test_model_parity import make_value
from shiftnet_tpu_torch.models import build_model, init_state
from shiftnet_tpu_torch.ops import chw
from shiftnet_tpu_torch.tools.convert import state_from_jax
from shiftnet_tpu_torch.tools.params_io import (drop_unused_reference_keys,
                                                load_reference_checkpoint,
                                                load_state)

CPU = jax.devices('cpu')[0]
# Narrow widths, one orb, two shift rounds; n_feats2=48 gives 3 channels per
# shift group number, so the outer and inner direction groups are all used.
TINY = dict(n_feats0=8, n_feats2=48, num_orbs=1, tfr_scale=4, shift_rounds=2)


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


def reference_state(model):
    """The fixture generator's weights (``tests/gen_fixtures.py``), keyed by
    the port's state_dict."""
    state = {}
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else None
        state[key] = torch.from_numpy(make_value(key, shape, fan_in))
    return state


def test_deblur_plus_keys_are_the_reference_keys():
    fx = load_fixture('model_deblur_plus')
    torch_keys = set(str(fx['torch_keys']).split('\n'))
    ours = set(build_model('deblur_plus').state_dict())
    assert ours <= torch_keys
    # registered but unused by the reference (test_model_parity.py:101-109)
    assert torch_keys - ours == {'lrelu.weight', 'stage1.act.weight'}
    assert set(drop_unused_reference_keys(
        dict.fromkeys(torch_keys), 'deblur_plus')) == ours


def test_deblur_plus_matches_reference_output():
    fx = load_fixture('model_deblur_plus')
    model = build_model('deblur_plus')
    model.load_state_dict(reference_state(model), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(fx['x'][0])).numpy()
    want = fx['out']
    tol = max(5e-4, 5.0 * float(fx['self_err']))
    assert out.shape == want.shape
    assert norm_err(out, want) < tol


def jax_tiny(t=6, h=32, w=32):
    model = jax_build_model('deblur_plus', **TINY)
    x = jnp.zeros((t, h, w, 3))
    tpl = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    return model, tpl['params']


@pytest.fixture(scope='module')
def tiny_pair():
    """(port state, JAX params holding the same weights, a clip, the JAX
    unfused forward of that clip)."""
    state = init_state(build_model('deblur_plus', **TINY), seed=3)
    jmodel, tpl = jax_tiny()
    params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                 tpl)
    x = np.random.default_rng(4).uniform(0, 1, (6, 32, 32, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, v: jmodel.apply({'params': p}, v))(
        params, jnp.asarray(x))
    return state, params, x, np.asarray(want)


@pytest.mark.parametrize('fused_tfr', [True, False])
def test_tiny_forward_matches_jax_unfused(tiny_pair, fused_tfr):
    state, _, x, want = tiny_pair
    model = build_model('deblur_plus', fused_tfr=fused_tfr, **TINY)
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (4, 3, 32, 32)
    assert norm_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4


def test_tiny_fused_chw_forward_matches_jax_unfused(tiny_pair):
    """The fused_chw composition (every CAB, conv, SkipUpSample and shift
    block through ops/chw and ops/naf_chw; their plain versions on the CPU)
    against the JAX unfused forward, with the input left unwritten."""
    state, _, x, want = tiny_pair
    model = build_model('deblur_plus', fused_chw=True, **TINY)
    model.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    x0 = xt.clone()
    chw.reset_launches()
    with torch.inference_mode():
        got = model(xt)
    assert set(chw.LAUNCHES.values()) == {0}  # CPU: no kernel launched
    assert torch.equal(xt, x0)
    assert norm_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4


def test_state_from_jax_round_trips_exactly(tiny_pair):
    state, params, _, _ = tiny_pair
    back = state_from_jax(jax.tree.map(np.asarray, params))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    build_model('deblur_plus', **TINY).load_state_dict(back, strict=True)


def test_load_state_reads_torch_keyed_npz(tmp_path):
    state = init_state(build_model('deblur_plus'), seed=5)
    path = tmp_path / 'net.npz'
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    loaded = load_state('deblur_plus', str(path))
    build_model('deblur_plus').load_state_dict(loaded, strict=True)
    assert all(torch.equal(loaded[k], state[k]) for k in state)


def test_load_state_drops_unused_reference_pth_keys(tmp_path):
    state = init_state(build_model('deblur_plus'), seed=6)
    ref = dict(state, **{'lrelu.weight': torch.full((1,), 0.25),
                         'stage1.act.weight': torch.full((1,), 0.25)})
    path = tmp_path / 'net_g.pth'
    torch.save({'params': ref}, path)
    loaded = load_state('deblur_plus', str(path))
    assert set(loaded) == set(state)
    build_model('deblur_plus').load_state_dict(loaded, strict=True)


@pytest.mark.parametrize('wrap', ['params', 'state_dict', None])
def test_load_reference_checkpoint_unwraps(tmp_path, wrap):
    state = {'a.weight': torch.arange(6.0).reshape(2, 3)}
    path = tmp_path / 'net.pth'
    torch.save(state if wrap is None else {wrap: state}, path)
    got = load_reference_checkpoint(str(path))
    assert set(got) == {'a.weight'}
    np.testing.assert_array_equal(got['a.weight'], state['a.weight'].numpy())


def test_init_state_is_seeded_and_order_free():
    a = init_state(build_model('deblur_plus', **TINY), seed=7)
    b = init_state(build_model('deblur_plus', **TINY), seed=7)
    c = init_state(build_model('deblur_plus', **TINY), seed=8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['conv_last.weight'], c['conv_last.weight'])
    cab2 = 'stage1.decoder_level1.encoder_level1.0'
    assert a[f'{cab2}.beta'].abs().sum() > 0  # shift blocks are not identities
    assert not a[f'{cab2}.norm.bias'].any()
    assert torch.equal(a[f'{cab2}.norm.weight'],
                       torch.ones_like(a[f'{cab2}.norm.weight']))
