"""The port's training path against the JAX package's, on the CPU.

- One train step (float32, tiny widths, ``num_orbs=1, shift_rounds=2``),
  port against JAX from the same parameters carried across
  (``tools/convert.state_from_jax``): loss and grad norm to 1e-5 relative,
  every gradient to 1e-4 by the normalized max error of
  ``tests/test_model_parity.py:118-128``; deblur_plus, deblur_small, and
  denoise_plus with the sigma and noise JAX draws, handed to the port.
  Each variant's JAX step compiles once (a module fixture).
- The fused model's gradients (kernel ops forward, here their plain
  versions, and ``ops/chw_grad``'s backward) against the unfused port and
  JAX; no fused op writes in place while autograd records.
- The schedules, the AdamW update and its clip, and the losses against
  ``shiftnet_tpu/train``.
- The trainer: bitwise resume (``T_max`` pinned, as
  ``tests/test_trainer.py:44-50``), a falling loss, validation through the
  metric registry; the CLI on a copy of ``configs/gopro_deblur.yml``; the
  ``.npz`` export read by the JAX package.
"""
import contextlib
import math
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from PIL import Image

from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.train import optim as joptim
from shiftnet_tpu.train import schedulers as jsched
from shiftnet_tpu.train.checkpoint import load_params_npz as jax_load_npz
from shiftnet_tpu.train.step import TaskConfig as JaxTask
from shiftnet_tpu.train.step import TrainState, make_train_step
from shiftnet_tpu_torch.models import build_model, init_params
from shiftnet_tpu_torch.models.layers import (CAB, Conv2d,
                                              EncoderShiftBlock, PReLU)
from shiftnet_tpu_torch.ops import chw, naf_chw
from shiftnet_tpu_torch.tools import train as train_cli
from shiftnet_tpu_torch.tools.convert import (flax_path_to_torch_key,
                                              state_from_jax)
from shiftnet_tpu_torch.train import optim, schedulers
from shiftnet_tpu_torch.train.checkpoint import save_params_npz
from shiftnet_tpu_torch.train.step import TaskConfig, train_step
from shiftnet_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices('cpu')[0]
TINY = dict(n_feats0=8, n_feats2=32, num_orbs=1, tfr_scale=4, shift_rounds=2)
T, HW = 4, 32
# (parameter seed, JAX key) of each step comparison: points where every
# ReLU input of the forward is at least RELU_MARGIN from its kink, checked
# in float64 (``relu_margin``).  At a ReLU input within float32 rounding of
# 0 (a CALayer's pre-activation of 1.4e-8 at (7, 5) in denoise_plus) the
# float32 gate of either package may fall either way, and the weights
# before it get a different gradient: 4e-3 normalized, where both packages
# stay within 2e-5 of float64 elsewhere.
STEP_SEEDS = {'deblur_plus': (7, 5), 'deblur_small': (11, 5),
              'denoise_plus': (15, 6)}
RELU_MARGIN = 1e-6


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Torch on one thread here: these are small ops, and under the
    6-worker tier-1 run more threads a process only contend (alone, one
    thread takes 5 % longer and half the CPU time)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = jax.config.jax_default_device
    jax.config.update('jax_default_device', CPU)
    yield
    jax.config.update('jax_default_device', prev)


def norm_err(a, b):
    """max|a - b| over the spread of b, the normalized max error of
    ``tests/test_model_parity.py:118-128``, with the RMS of b as its spread
    (the std there) so that one-element leaves (PReLU slopes) have one.  An
    all-zero b (a ReLU that never fires, a CAB2's spatial shift that moves
    everything out of a 4x4 frame) must be matched exactly."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.any():
        return 0.0 if not a.any() else float('inf')
    return float(np.max(np.abs(a - b)) / np.sqrt(np.mean(b * b)))


@contextlib.contextmanager
def torch_cpu_convs():
    """oneDNN's CPU convolutions sum in an order that loses about 3e-3 of
    the smallest gradients here (a CAB's weights whose gradient RMS is
    1e-6 of conv_last's), measured against the port in float64; torch's
    own CPU convolutions and XLA's stay within 1e-4 of float64.  The step
    comparisons run on torch's own."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


@pytest.fixture
def exact_cpu_convs():
    with torch_cpu_convs():
        yield


def jax_tree(model, seed):
    """A flax parameter tree for the port model's JAX twin, laid out by
    ``optim.flax_paths``, with seeded scaled-normal values (conv kernels
    0.3 / sqrt(fan_in), betas 0.1, LayerNorm / PReLU weights 1 + 0.1 N)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree = {}
    for key, path in optim.flax_paths(model).items():
        *mods, leaf = path.split('/')
        shape = shapes[key]
        if leaf == 'kernel':
            shape = (shape[2], shape[3], shape[1], shape[0])
            v = 0.3 / np.sqrt(np.prod(shape[:3])) * rng.standard_normal(shape)
        elif leaf == 'beta':
            shape = (1, 1, 1, shape[1])
            v = 0.1 * rng.standard_normal(shape)
        elif leaf == 'weight':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v.astype(np.float32)
    return tree


def flat_torch(tree):
    """A flax tree's leaves by torch key, in the torch layout."""
    return {k: v.numpy() for k, v in state_from_jax(tree).items()}


def recording_tx():
    """An optax transformation that leaves the params and keeps the
    gradients as its state: the JAX step's gradients, from one compile."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def relu_margin(run):
    """The smallest |input| of any ReLU in the port's float64 forward of
    the run's first clip."""
    model = build_model(run['variant'], **TINY).double()
    model.load_state_dict({k: v.double() for k, v in
                           state_from_jax(run['tree']).items()})
    x = run['batch']['gt'][0]
    nm = None
    if run['draws'] is not None:
        sigma, noise = run['draws']
        x = x + noise[0].numpy().transpose(0, 2, 3, 1)
        nm = torch.full((T, 1, HW, HW), float(sigma[0]), dtype=torch.float64)
    else:
        x = run['batch']['lq'][0]
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.ReLU):
            m.register_forward_hook(
                lambda m, i, o: seen.append(float(i[0].abs().min())))
    with torch.no_grad():
        model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).double(), nm)
    return min(seen)


@pytest.fixture(scope='module', params=list(STEP_SEEDS))
def jax_step(request):
    """JAX's train step on seeded params and a seeded batch: the tree, the
    batch (NHWC), the denoise draws in the port's layout, the loss, the
    grad norm and the gradients by torch key."""
    variant = request.param
    seed, key_seed = STEP_SEEDS[variant]
    tree = jax_tree(build_model(variant, **TINY), seed=seed)
    jmodel = jax_build_model(variant, **TINY)
    cfg = jmodel.cfg
    task = JaxTask(kind='denoise' if cfg.noise_map else 'deblur',
                   center_slice=(cfg.past_frames, cfg.future_frames))
    rng = np.random.default_rng(3)
    batch = {'gt': rng.uniform(0, 1, (1, T, HW, HW, 3)).astype(np.float32)}
    if task.kind == 'deblur':
        batch['lq'] = np.clip(batch['gt'] + rng.normal(
            0, 0.1, batch['gt'].shape), 0, 1).astype(np.float32)
    key = jax.random.PRNGKey(key_seed)
    tx = recording_tx()
    with jax.default_device(CPU):
        step = jax.jit(make_train_step(jmodel, tx, task))
        params = jax.tree.map(jnp.asarray, tree)
        state, metrics = step(TrainState.create(params, tx),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              key)
    draws = None
    if task.kind == 'denoise':  # the draws of shiftnet_tpu/train/step.py:62-67
        rng_sigma, rng_noise, _ = jax.random.split(key, 3)
        lo, hi = task.sigma_range
        sigma = jax.random.uniform(rng_sigma, (1, 1, 1, 1, 1), minval=lo,
                                   maxval=hi)
        noise = jax.random.normal(rng_noise, batch['gt'].shape) * sigma
        draws = (torch.from_numpy(np.asarray(sigma).reshape(1)),
                 torch.from_numpy(np.asarray(noise).transpose(0, 1, 4, 2, 3)))
    grads = flat_torch(jax.device_get(state.opt_state))
    run = dict(variant=variant, tree=tree, batch=batch, draws=draws,
               loss=float(metrics['loss']),
               grad_norm=float(metrics['grad_norm']), grads=grads,
               step=step, params=params, tx=tx, key=key)
    assert relu_margin(run) >= RELU_MARGIN
    with torch_cpu_convs():
        run['grads64'] = port_step(run, dtype=torch.float64)[1]
    return run


def port_step(run, fused=False, dtype=torch.float32):
    """The port's step on the fixture's params and batch: (metrics,
    gradients by torch key, model)."""
    model = build_model(run['variant'], fused_chw=fused, **TINY).to(dtype)
    model.load_state_dict(state_from_jax(run['tree']), strict=True)
    cfg = model.cfg
    task = TaskConfig(kind='denoise' if cfg.noise_map else 'deblur',
                      center_slice=(cfg.past_frames, cfg.future_frames),
                      dtype=dtype)
    opt = optim.build_optimizer(model, optim.OptimConfig())
    batch = {k: torch.from_numpy(v.transpose(0, 1, 4, 2, 3).copy()).to(dtype)
             for k, v in run['batch'].items()}
    draws = run['draws'] and tuple(d.to(dtype) for d in run['draws'])
    metrics = train_step(model, opt, task, batch, None, draws=draws)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return metrics, grads, model


def disagreeing(grads, run, tol=1e-4):
    """The leaves of ``grads`` (float32) more than ``tol`` from JAX's, but
    those where JAX's own float32 gradient is what is off: JAX's more than
    ``tol`` (and less than 1e-3) from the port's float64 gradient, and
    ``grads`` within ``tol`` of it.  (Isolated CALayer weights: 3.6e-4
    for JAX where the port is at 2.9e-5, deblur_small.)  A wrong gradient
    is off by far more than 1e-3, so it cannot pass as JAX's rounding."""
    bad = {}
    for k, g in grads.items():
        err = norm_err(g, run['grads'][k])
        if err < tol:
            continue
        jax_err = norm_err(run['grads'][k], run['grads64'][k])
        port_err = norm_err(g, run['grads64'][k])
        if not (tol <= jax_err < 1e-3 and port_err < tol):
            bad[k] = (err, jax_err, port_err)
    return bad


def test_train_step_matches_jax(jax_step, exact_cpu_convs):
    metrics, grads, _ = port_step(jax_step)
    loss, gnorm = float(metrics['loss']), float(metrics['grad_norm'])
    assert abs(loss - jax_step['loss']) <= 1e-5 * abs(jax_step['loss'])
    assert abs(gnorm - jax_step['grad_norm']) <= 1e-5 * jax_step['grad_norm']
    assert grads.keys() == jax_step['grads'].keys()
    assert not disagreeing(grads, jax_step)


def test_fused_grads_match_unfused_and_jax(jax_step, exact_cpu_convs):
    """The fused model (kernel ops forward, on the CPU their plain versions;
    ``ops/chw_grad`` backward, with the differentiable ``prep_naf``)
    against the unfused port and JAX's unfused step."""
    m_f, g_f, model = port_step(jax_step, fused=True)
    m_u, g_u, _ = port_step(jax_step)
    assert model.cfg.fused_chw
    assert abs(float(m_f['loss']) - float(m_u['loss'])) <= 1e-5 * abs(
        float(m_u['loss']))
    errs = {k: norm_err(g, g_u[k]) for k, g in g_f.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])
    assert not disagreeing(g_f, jax_step)


@pytest.mark.parametrize('jax_step', ['deblur_plus'], indirect=True)
def test_npz_export_loads_in_jax(jax_step, tmp_path):
    """An npz saved by the port loads through JAX's ``load_params_npz`` to
    the same parameters, and JAX's step on them gives the same loss."""
    model = build_model('deblur_plus', **TINY)
    model.load_state_dict(state_from_jax(jax_step['tree']), strict=True)
    path = str(tmp_path / 'net.npz')
    save_params_npz(path, model.state_dict())
    loaded = jax_load_npz(path, jax_step['params'])
    for a, b in zip(jax.tree.leaves(loaded),
                    jax.tree.leaves(jax_step['params'])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tx = jax_step['tx']
    with jax.default_device(CPU):
        _, metrics = jax_step['step'](
            TrainState.create(loaded, tx),
            {k: jnp.asarray(v) for k, v in jax_step['batch'].items()},
            jax_step['key'])
    assert float(metrics['loss']) == jax_step['loss']


def test_no_inplace_write_while_autograd_records(monkeypatch):
    """The fused model writes over dead inputs at inference (cab_back,
    naf_back in place) and never while autograd records; a kernel op asked
    to write in place over a tensor that requires grad raises."""
    calls = []
    for mod, name in ((chw, 'cab_back'), (naf_chw, 'naf_back')):
        orig = getattr(mod, name)

        def spy(*args, inplace=False, _orig=orig, **kw):
            calls.append(inplace)
            return _orig(*args, inplace=inplace, **kw)

        monkeypatch.setattr(mod, name, spy)
    model = init_params(build_model('denoise_plus', fused_chw=True, **TINY))
    x = torch.rand(T, 3, HW, HW)
    nm = torch.full((T, 1, HW, HW), 0.1)
    with torch.inference_mode():
        model(x, nm)
    assert any(calls) and not all(calls)
    calls.clear()
    model(x, nm).mean().backward()
    assert calls and not any(calls)
    y = torch.rand(1, 8, 4, 4, requires_grad=True)
    s, ca = torch.rand(1, 8, 4, 4), torch.rand(1, 8)
    with pytest.raises(RuntimeError, match='requires grad'):
        chw.cab_back(y, s, ca, inplace=True)
    with torch.no_grad():
        assert chw.cab_back(y, s, ca).shape == y.shape


def test_kept_panel_follows_the_optimizer_step():
    """A weight panel kept on a parameter (``chw._kept_panel``) is repacked
    after an AdamW step: the in-place updates bump the version."""
    conv = torch.nn.Conv2d(16, 16, 3, bias=False)
    w = conv.weight
    before = chw.tap_panel(w, torch.float32).clone()
    w.grad = torch.rand_like(w)
    opt = optim.AdamW([{'params': [w]}], optim.OptimConfig(lr=0.1))
    version = w._version
    opt.step()
    assert w._version > version
    after = chw.tap_panel(w, torch.float32)
    layout = chw.mma_layout(16, 16, 4)
    assert not torch.equal(before, after)
    assert torch.equal(after, chw.pack_taps(w.detach(), *layout))


# -- schedules, optimizer, losses --------------------------------------------

SCHEDULES = [
    ('cosine', 4e-4, 300_000, dict(eta_min=1e-7)),
    ('cosine', 4e-4, 1000, dict(eta_min=1e-7, T_max=600, warmup_iter=50)),
    ('CosineAnnealingRestartLR', 1e-3, 40,
     dict(periods=[10, 10, 10, 10], restart_weights=[1, 0.5, 0.5, 0.5],
          eta_min=1e-7)),
    ('LinearLR', 1e-3, 1000, {}),
    ('MultiStepRestartLR', 1e-3, 1000,
     dict(milestones=[100, 200, 700], gamma=0.1, restarts=[0, 500],
          restart_weights=[1, 0.5])),
    ('VibrateLR', 1e-3, 8000, {}),
]


@pytest.mark.parametrize('kind,lr,total,kw', SCHEDULES)
def test_schedules_match_jax(kind, lr, total, kw):
    """To 1e-12 (JAX in 64-bit mode).  JAX's MultiStepRestartLR starts
    from ``jnp.asarray(lr, jnp.float32)``, so the port's is given that
    float32 lr."""
    port_lr = float(np.float32(lr)) if kind == 'MultiStepRestartLR' else lr
    port = schedulers.build_schedule(kind, port_lr, total, **kw)
    steps = sorted({0, 1, 9, 10, 11, 49, 50, 77, 120, 499, 500, 501, 650,
                    3100, 5100, 7900, total - 1, total})
    with jax.enable_x64(True):
        ref = jsched.build_schedule(kind, lr, total, **kw)
        for s in steps:
            assert abs(port(s) - float(ref(jnp.asarray(s)))) < 1e-12, s


def test_adamw_matches_optax():
    """Two updates of identical gradients, with the global-norm clip, weight
    decay, the schedule and the 1.5x group of the denoise recipe: every
    parameter within 1e-6 of the LR of optax's, and the groups labelled as
    ``optim._group_scale_mask`` labels the JAX tree."""
    model = torch.nn.Module()  # a few of denoise_plus's modules, by name
    model.stage1 = torch.nn.Module()
    model.stage1.decoder_level1 = EncoderShiftBlock(32, rounds=1,
                                                    mid_ca=True,
                                                    last_bias=True)
    model.stage1.skip_attn1 = CAB(32)
    model.lrelu = PReLU()
    model.conv_last = Conv2d(8, 3, 3)
    tree = jax_tree(model, seed=1)
    model.load_state_dict(state_from_jax(tree), strict=True)
    scales = {'stage1/decoder_level': 1.5}
    kw = dict(lr=1.0, weight_decay=0.01, total_iters=10, eta_min=0.05,
              grad_clip=0.5, lr_group_scales=scales)
    port = optim.build_optimizer(model, optim.OptimConfig(**kw))
    params = jax.tree.map(jnp.asarray, tree)
    tx = joptim.build_optimizer(joptim.OptimConfig(**kw), params)
    state = tx.init(params)
    labels = joptim._group_scale_mask(params, scales)
    want = {flax_path_to_torch_key(tuple(p.key for p in path)): label
            for path, label in jax.tree_util.tree_flatten_with_path(labels)[0]}
    got = {k: g['label'] for g in port.param_groups for k in g['names']}
    assert got == want and {'', 'stage1/decoder_level'} == set(got.values())
    rng = np.random.default_rng(2)
    for _ in range(2):
        gtree = jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(
            np.float32), tree)
        gflat = flat_torch(gtree)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(gflat[k].copy())
        port.step()
        updates, state = tx.update(jax.tree.map(jnp.asarray, gtree), state,
                                   params)
        params = optax.apply_updates(params, updates)
        ref = flat_torch(jax.device_get(params))
        for k, p in model.named_parameters():
            assert np.max(np.abs(p.detach().numpy() - ref[k])) <= 1e-6 * kw[
                'lr'], k


@pytest.mark.parametrize('ratio', [1 + 1e-3, 1 - 1e-3])
def test_clip_formula_matches_optax(ratio):
    """At g_norm just above max_norm optax scales by max_norm / g_norm; just
    below it leaves the gradients as they are (torch's clip_grad_norm_
    would scale both by max_norm / (g_norm + 1e-6))."""
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                         for g in grads))
    max_norm = float(norm / ratio)
    got, gnorm = optim.clip_by_global_norm([torch.from_numpy(g)
                                            for g in grads], max_norm)
    clip = optax.clip_by_global_norm(max_norm)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    assert abs(float(gnorm) - norm) <= 1e-6 * norm
    for a, b, g in zip(got, want, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
        if ratio < 1:
            np.testing.assert_array_equal(a.numpy(), g)
        else:
            assert np.max(np.abs(a.numpy())) < np.max(np.abs(g))


def nhwc_pair(seed, shape=(2, 3, 8, 10, 3)):
    """Predictions and targets on a 1/8 grid in [-2, 2]: every difference,
    square and sum is exact in float32, so the comparison sees the loss
    formulas and not the summation order."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, shape) / 8).astype(np.float32)
    y = (rng.integers(-16, 17, shape) / 8).astype(np.float32)
    return x, y, *(torch.from_numpy(np.moveaxis(v, -1, -3).copy())
                   for v in (x, y))


@pytest.mark.parametrize('name', ['l1_loss', 'mse_loss', 'psnr_loss',
                                  'hem_loss'])
def test_losses_match_jax(name):
    x, y, xt, yt = nhwc_pair(0)
    kw = {'random_thre_p': 0.0} if name == 'hem_loss' else {}
    got = float(getattr(optim, name)(xt, yt, **kw))
    want = float(getattr(joptim, name)(jnp.asarray(x), jnp.asarray(y), **kw))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_hem_random_mask_count():
    """Uniform residual: the hard mask is empty (strictly greater), and the
    random mask holds exactly int(0.1 * h * w) pixels per frame."""
    x, y = torch.zeros(2, 3, 16, 16), torch.ones(2, 3, 16, 16)
    assert float(optim.hem_loss(x, y)) == 0.0
    gen = torch.Generator().manual_seed(0)
    assert abs(float(optim.hem_loss(x, y, generator=gen)) - 25 / 256) < 1e-6


@pytest.mark.parametrize('spec', ['1*L1', '1*L1+2*PSNR', '0.5*MSE+1*HEM',
                                  '2*L2'])
def test_build_loss_spec_matches_jax(spec):
    x, y, xt, yt = nhwc_pair(1)
    got = float(optim.build_loss(spec)(xt, yt))
    want = float(joptim.build_loss(spec)(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert optim.parse_loss_spec(spec) == [
        (float(w), n.strip()) for w, n in (t.split('*')
                                           for t in spec.split('+'))]
    with pytest.raises(ValueError):
        optim.build_loss('1*SSIM')


# -- trainer and CLI -------------------------------------------------------------

@pytest.fixture(scope='module')
def synth_ds(tmp_path_factory):
    """Two clips of 8 frames, gt and blur; 104x96 so that NIQE (96-pixel
    blocks) scores one block."""
    root = tmp_path_factory.mktemp('synth_ds')
    rng = np.random.default_rng(0)
    for sub in ('gt', 'blur'):
        for v in ('clip1', 'clip2'):
            d = root / 'train' / sub / v
            d.mkdir(parents=True)
            base = rng.integers(0, 255, (104, 96, 3))
            for i in range(8):
                img = np.clip(base + rng.integers(-20, 20, (104, 96, 3)),
                              0, 255).astype(np.uint8)
                Image.fromarray(img).save(d / f'{i:03d}.png')
    return str(root / 'train')


def make_opt(exp, data, total_iter, t_max=None):
    return {
        'name': 'smoke', 'model': 'deblur_small',
        'model_overrides': dict(TINY), 'bf16': False, 'fused': False,
        'n_sequence': T, 'patch_size': HW, 'manual_seed': 3, 'device': 'cpu',
        'datasets': {'train': {'dir_data': data, 'num_worker_per_gpu': 1}},
        'train': {'total_iter': total_iter, 'optim_g': {'lr': 2e-4},
                  'scheduler': {'type': 'cosine', 'eta_min': 1e-7,
                                **({'T_max': t_max} if t_max else {})},
                  'grad_clip': 0.01},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 1000},
        'path': {'experiments_root': exp, 'log': exp,
                 **{k: os.path.join(exp, k) for k in (
                     'models', 'training_states', 'visualization')}},
    }


def test_trainer_resume_is_bitwise(synth_ds, tmp_path):
    """4 uninterrupted steps equal 2 steps, then a new Trainer that
    auto-resumes and finishes; the cosine horizon pinned by T_max."""
    a = Trainer(make_opt(str(tmp_path / 'a'), synth_ds, 4, t_max=4))
    a.run()
    assert a.step == 4 and (tmp_path / 'a' / 'models' / 'net_g_4.npz').exists()
    Trainer(make_opt(str(tmp_path / 'b'), synth_ds, 2, t_max=4)).run()
    b = Trainer(make_opt(str(tmp_path / 'b'), synth_ds, 4, t_max=4))
    assert b.step == 2 and b.loader.start_batch == 2
    b.run()
    assert b.ckpt.steps() == [2, 4]
    assert 'auto-resumed from step 2' in (tmp_path / 'b' / 'train.log'
                                          ).read_text()
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert all(torch.equal(oa['state'][i]['nu'], ob['state'][i]['nu'])
               for i in oa['state'])


def test_trainer_loss_decreases(synth_ds, tmp_path):
    tr = Trainer(make_opt(str(tmp_path / 'c'), synth_ds, 6))
    losses = []
    for i, batch in enumerate(tr.loader):
        if i == 6:
            break
        b = {k: torch.from_numpy(v).permute(0, 1, 4, 2, 3).contiguous()
             for k, v in batch.items()}
        m = train_step(tr.model, tr.optimizer, tr.task, b, tr.generator(i))
        losses.append(float(m['loss']))
    tr.loader.stop()
    assert losses[-1] < losses[0], losses


def test_trainer_validate_metric_registry(synth_ds, tmp_path):
    opt = make_opt(str(tmp_path / 'v'), synth_ds, 1)
    val = {'dir_data': synth_ds, 'one_len': 4,
           'metrics': {'psnr': {'type': 'psnr'},
                       'niqe': {'type': 'calculate_niqe', 'crop_border': 0}}}
    tr = Trainer(opt)
    res = tr.validate(0, val)
    tr.loader.stop()
    ev = tr._validator
    assert set(ev.metrics) == {'psnr', 'niqe'} and res['n_frames'] > 0
    assert np.isfinite(res['psnr']) and np.isfinite(res['niqe'])
    log = open(ev.logger.path).read()
    assert 'AVG-PSNR' in log and 'AVG-NIQE' in log


def config_copy(name, tmp_path, **changes):
    opt = yaml.safe_load((REPO / 'configs' / name).read_text())
    opt.update(changes)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(opt))
    return str(path)


def test_train_cli_on_gopro_config(synth_ds, tmp_path):
    """``tools/train.py -opt`` on configs/gopro_deblur.yml with the data
    path, the widths and the run's length changed (bf16 as configured,
    plain on the CPU); then the tp8 config, which must raise in one
    process: its time ring needs 8 ranks (tests/test_torch_parallel.py
    runs a time ring)."""
    opt = yaml.safe_load((REPO / 'configs' / 'gopro_deblur.yml').read_text())
    opt['train']['total_iter'] = 2
    path = config_copy(
        'gopro_deblur.yml', tmp_path, datasets={'train': {
            'dir_data': synth_ds, 'num_worker_per_gpu': 1}},
        model_overrides=TINY, n_sequence=T, patch_size=HW,
        train=opt['train'], experiments_root=str(tmp_path / 'exp'),
        logger={'print_freq': 1, 'save_checkpoint_freq': 1000})
    tr = train_cli.main(['-opt', path, '--device', 'cpu'])
    assert tr.step == 2 and tr.task.dtype == torch.bfloat16
    assert not tr.model.cfg.fused_chw
    log = (tmp_path / 'exp' / 'gopro_deblur' / 'train.log').read_text()
    assert re.search(r'iter +2 lr', log) and 'training complete' in log
    assert (tmp_path / 'exp' / 'gopro_deblur' / 'models' /
            'net_g_2.npz').exists()
    tp8 = config_copy('gopro_deblur_tp8.yml', tmp_path,
                      experiments_root=str(tmp_path / 'exp'))
    with pytest.raises(ValueError, match='time_parallel 8 needs a multiple '
                       'of 8 ranks; this run has 1'):
        train_cli.main(['-opt', tp8, '--device', 'cpu'])
