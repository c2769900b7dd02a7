"""The port's parallel paths on CPU ranks (``torch.distributed``, gloo)
against the unsharded port and the JAX package.

Ranks are started by ``shiftnet_tpu_torch.parallel.launch.run`` and run
the rank functions of ``parallel/workers.py``; the references are computed
here, in the parent process.  Widths are tiny (``tests/test_multichip.py``'s
``TINY``).

- The ring exchange, the sharded temporal shift and the sharded GSTS
  round (``ring_edge``) at 2 and 4 ranks, forward and reverse, with and
  without the boundary patch: equal to the unsharded shift bit for bit,
  and so is the gradient.
- ``temporal_parallel_forward`` (halo 2) against JAX's single-device
  ``model.apply`` on windows built by the JAX code's edge rule
  (``shiftnet_tpu/parallel/temporal.py:64-65``), to 1e-5; the Evaluator's
  ``tp`` on an uneven split (never padded), and for denoise with its noise
  map; the grids forward and the quadrant plan raise under tp.
- The trainer on 2 ranks with ``time_parallel: 2``, with a resume: bit for
  bit the uninterrupted run, only the primary rank writes.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from PIL import Image

from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from shiftnet_tpu_torch.eval.runner import HALO, Evaluator
from shiftnet_tpu_torch.models import build_model, init_state
from shiftnet_tpu_torch.ops.shift import gsts, temporal_channel_shift
from shiftnet_tpu_torch.parallel import launch, workers
from shiftnet_tpu_torch.parallel.temporal import shard_bounds
from shiftnet_tpu_torch.tools import test_deblur, test_denoise

CPU = jax.devices('cpu')[0]
TINY = dict(n_feats0=8, n_feats2=16, num_orbs=1, tfr_scale=4,
            shift_rounds=1, encoder2_levels=2)
P = 16
SIGMA = 10.0 / 255.0
SHIFT_CASES = [(False, True), (True, True), (False, False), (True, False)]


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rel_l2(a, b):
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    return np.sqrt(num / sum(float(b[k].double().square().sum())
                             for k in b))


# -- the ring exchange and the sharded temporal shift -------------------------

def normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.fixture(scope='module', params=[2, 4])
def shift_run(request):
    rng = np.random.default_rng(0)
    x = normal(rng, 8, 6, 3, 4)
    cot = normal(rng, *x.shape)
    xg = normal(rng, 8, 16, 9, 10)
    cots = (normal(rng, *xg.shape), normal(rng, 8, 8, 9, 10))
    return request.param, x, cot, (xg, cots), launch.run(
        workers.shift_cases, request.param, x, cot, xg, cots, SHIFT_CASES)


@pytest.mark.parametrize('reverse,patch', SHIFT_CASES)
def test_sharded_shift_equals_unsharded(shift_run, reverse, patch):
    n, x, cot, _, ranks = shift_run
    xx = x.clone().requires_grad_(True)
    y = temporal_channel_shift(xx, reverse=reverse, boundary_patch=patch)
    (y * cot).sum().backward()
    got = torch.cat([r[reverse, patch][0] for r in ranks])
    grad = torch.cat([r[reverse, patch][1] for r in ranks])
    assert torch.equal(got, y.detach())
    assert torch.equal(grad, xx.grad)


@pytest.mark.parametrize('reverse,patch', SHIFT_CASES)
def test_sharded_gsts_round_equals_unsharded(shift_run, reverse, patch):
    """``gsts`` with ``ring_edge`` (the shift block's round on a ring,
    which the fused form runs after the shift_round kernel): y, hw and the
    gradient bit for bit the unsharded round's."""
    _, _, _, (xg, cots), ranks = shift_run
    xx = xg.clone().requires_grad_(True)
    y, hw = gsts(xx, 1, reverse=reverse, boundary_patch=patch)
    ((y * cots[0]).sum() + (hw * cots[1]).sum()).backward()
    got = [torch.cat([r['gsts', reverse, patch][i] for r in ranks])
           for i in range(3)]
    assert torch.equal(got[0], y.detach())
    assert torch.equal(got[1], hw.detach())
    assert torch.equal(got[2], xx.grad)


def test_exchange_reaches_the_ring_neighbours(shift_run):
    """Rank r receives r - 1 from its left and 10 (r + 1) from its right
    (mod n); the gradients go back: 1 from the right neighbour's first
    output, 2 x 10 from the left neighbour's second."""
    n, _, _, _, ranks = shift_run
    for r, res in enumerate(ranks):
        (from_left, from_right), grad = res['exchange']
        assert torch.equal(from_left, torch.full((2,), float((r - 1) % n)))
        assert torch.equal(from_right,
                           torch.full((2,), 10.0 * ((r + 1) % n)))
        assert torch.equal(grad, torch.full((2,), 21.0))


# -- tp inference --------------------------------------------------------------

def jax_forward(variant, state, sigma=None):
    """JAX's single-device forward (past = future = HALO) on the port's
    weights, jitted."""
    jmodel = jax_build_model(variant, past_frames=HALO, future_frames=HALO,
                             **TINY)
    args = [jnp.zeros((2 * HALO + 1, P, P, 3))]
    if sigma is not None:
        args.append(jnp.zeros((2 * HALO + 1, P, P, 1)))
    with jax.default_device(CPU):
        tpl = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                 *args))
        params = torch_state_to_flax({k: v.numpy() for k, v in state.items()},
                                     tpl['params'])
        if sigma is None:
            fwd = jax.jit(lambda v: jmodel.apply({'params': params}, v))
        else:
            fwd = jax.jit(lambda v: jmodel.apply(
                {'params': params}, v,
                jnp.full(v.shape[:3] + (1,), sigma, v.dtype)))

    def run(x):
        with jax.default_device(CPU):
            return np.asarray(fwd(jnp.asarray(x)))
    return run


def edge_rule_windows(x, n):
    """The windows of ``temporal.py:64-65``: each shard with HALO frames of
    each neighbour; at the ends the shard's own first / last HALO frames."""
    t = x.shape[0]
    out = []
    for s, e in shard_bounds(t, n):
        left = x[s - HALO:s] if s else x[:HALO]
        right = x[e:e + HALO] if e < t else x[t - HALO:]
        out.append(np.concatenate([left, x[s:e], right]))
    return out


def clip(t, seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (t, P, P, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def tp_setup():
    """Weights and JAX forwards for deblur_small and denoise_small."""
    states = {v: init_state(build_model(v, **TINY), seed=5)
              for v in ('deblur_small', 'denoise_small')}
    return states, {'deblur_small': jax_forward('deblur_small',
                                                states['deblur_small']),
                    'denoise_small': jax_forward('denoise_small',
                                                 states['denoise_small'],
                                                 SIGMA)}


@pytest.fixture(scope='module', params=[2, 4])
def tp_run(request, tp_setup):
    """On n ranks: ``temporal_parallel_forward`` on 6n frames (6 a rank),
    the Evaluator's tp on 6n - 1 frames (an uneven split) for deblur and
    on 6n frames for denoise."""
    n = request.param
    states, _ = tp_setup
    x_even, x_uneven = clip(6 * n, 1), clip(6 * n - 1, 2)
    x_dn = clip(6 * n, 3)
    nchw = torch.from_numpy(x_even).permute(0, 3, 1, 2).contiguous()
    kw = dict(overrides=TINY, bf16=False)
    jobs = [('tp_forward', ('deblur_small', TINY, states['deblur_small'],
                            nchw, None, HALO), {}),
            ('evaluator_windows', ('deblur_small', states['deblur_small'],
                                   [(x_uneven, None)]), kw),
            ('evaluator_windows', ('denoise_small', states['denoise_small'],
                                   [(x_dn, SIGMA)]), kw)]
    ranks = launch.run(workers.run_jobs, n, jobs)
    return n, (x_even, x_uneven, x_dn), [list(r) for r in zip(*ranks)]


def test_temporal_parallel_forward_matches_jax(tp_run, tp_setup):
    n, (x, _, _), (fwd, _, _) = tp_run
    jax_fwd = tp_setup[1]['deblur_small']
    want = np.concatenate([jax_fwd(w) for w in edge_rule_windows(x, n)])
    got = torch.cat(fwd).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_evaluator_tp_uneven_split_is_not_padded(tp_run, tp_setup,
                                                tmp_path):
    """T = 6n - 1: shards of 6 and 5 frames, each through its edge-rule
    window; the gathered centre equals the single-process forward of those
    windows bit for bit and JAX's to 1e-5; the log names the split."""
    n, (_, x, _), (_, ev_res, _) = tp_run
    states, jax_fwds = tp_setup
    t = x.shape[0]
    got = ev_res[0]['outs'][0].numpy()
    windows = edge_rule_windows(x, n)
    assert [w.shape[0] for w in windows] == [
        e - s + 2 * HALO for s, e in shard_bounds(t, n)]
    assert {w.shape[0] for w in windows} == {6 + 2 * HALO, 5 + 2 * HALO}
    ev = Evaluator('deblur_small', states['deblur_small'], device='cpu',
                   overrides=TINY, bf16=False, result_path=str(tmp_path))
    port = np.concatenate([ev.forward_window(w) for w in windows]
                          )[HALO:t - HALO]
    want = np.concatenate([jax_fwds['deblur_small'](w) for w in windows])
    assert got.shape == (t - 2 * HALO, P, P, 3)
    assert np.array_equal(got, port)
    np.testing.assert_allclose(got, want[HALO:t - HALO], rtol=1e-5,
                               atol=1e-5)
    sizes = [e - s for s, e in shard_bounds(t, n)]
    assert f'shards of {sizes} frames' in ev_res[0]['log']
    assert 'no frame repeated' in ev_res[0]['log']


def test_evaluator_tp_denoise_matches_jax(tp_run, tp_setup):
    n, (_, _, x), (_, _, ev_res) = tp_run
    jax_fwd = tp_setup[1]['denoise_small']
    want = np.concatenate([jax_fwd(w) for w in edge_rule_windows(x, n)])
    got = ev_res[0]['outs'][0].numpy()
    np.testing.assert_allclose(got, want[HALO:x.shape[0] - HALO], rtol=1e-5,
                               atol=1e-5)
    assert all(r['outs'][0] is None for r in ev_res[1:])  # rank 0 gathers
    # for scoring; the others keep nothing


def test_grids_and_quadrant_raise_under_tp(tp_run):
    _, _, (_, ev_res, dn_res) = tp_run
    for res in ev_res + dn_res:
        grids, quadrant = res['raised']
        assert 'forward_grids does not run under tp' in grids
        assert 'quadrant plan does not run under tp' in quadrant


def test_evaluator_tp_needs_its_process_group():
    state = init_state(build_model('deblur_small', **TINY), seed=5)
    with pytest.raises(ValueError, match='initialized process group of 2'):
        Evaluator('deblur_small', state, device='cpu', overrides=TINY, tp=2)


@pytest.mark.parametrize('cli', [test_deblur, test_denoise])
def test_cli_tp_must_match_world_size(cli, monkeypatch, tmp_path):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(SystemExit, match='--tp 2 with WORLD_SIZE 1'):
        cli.main(['--model_path', 'unused.npz', '--data_path',
                  str(tmp_path), '--tp', '2', '--device', 'cpu'])


# -- the trainer ---------------------------------------------------------------

def write_clips(root, n_clips, n_frames, seed):
    rng = np.random.default_rng(seed)
    for v in range(n_clips):
        base = rng.integers(0, 255, (40, 40, 3))
        for i in range(n_frames):
            img = np.clip(base + rng.integers(-20, 20, base.shape), 0, 255)
            for sub in ('gt', 'blur'):
                d = root / sub / f'clip{v}'
                d.mkdir(parents=True, exist_ok=True)
                Image.fromarray(img.astype(np.uint8)).save(d / f'{i:03d}.png')


def trainer_config(tmp_path, name, data, **changes):
    opt = yaml.safe_load(open('configs/gopro_deblur_tp8.yml'))
    opt.update(name=name, model='deblur_small', model_overrides=TINY,
               bf16=False, n_sequence=8, patch_size=P, time_parallel=2,
               experiments_root=str(tmp_path / 'exp'),
               logger={'print_freq': 1, 'save_checkpoint_freq': 2})
    opt['datasets']['train'].update(dir_data=str(data), num_worker_per_gpu=1)
    opt['train'].update(total_iter=4)
    opt['train']['scheduler']['T_max'] = 4
    opt.update(changes)
    path = tmp_path / f'{name}.yml'
    path.write_text(yaml.safe_dump(opt))
    return str(path)


def test_sequence_parallel_trainer_resumes_bitwise(tmp_path):
    """``time_parallel: 2`` on 2 ranks: 4 steps straight, and 2 steps then
    a resume to 4, end on the same weights bit for bit; each rank loads
    the whole clip and keeps its frames; only rank 0 writes.  The weights
    are within 1e-5 (relative L2 of the update) of one process training
    the same config without the ring."""
    data = tmp_path / 'data'
    write_clips(data, 2, 10, seed=4)
    straight = trainer_config(tmp_path, 'straight', data)
    resumed = trainer_config(tmp_path, 'resumed', data)
    ranks = launch.run(workers.run_jobs, 2, [
        ('train_cli', (straight, [4], 'cpu'), {}),
        ('train_cli', (resumed, [2, 4], 'cpu'), {})])
    (a0, b0), (a1, b1) = ranks
    assert [r['step'] for r in b0['runs']] == [2, 4]
    assert b0['runs'][0]['mesh'] == (1, 2)
    assert all(torch.equal(a0['params'][k], b0['params'][k])
               for k in a0['params'])
    assert all(torch.equal(a0['params'][k], a1['params'][k])
               for k in a0['params'])
    assert a0['runs'][0]['losses'] == b0['runs'][0]['losses'] + \
        b0['runs'][1]['losses']
    assert [r['primary'] for r in (a0['runs'][0], a1['runs'][0])] == [
        True, False]
    assert a0['saves'] and not a1['saves'] and not b1['saves']
    log = (tmp_path / 'exp' / 'resumed' / 'train.log').read_text()
    assert 'auto-resumed from step 2' in log
    assert 'mesh data 1 x time 2' in log
    from shiftnet_tpu_torch.tools import train as train_cli
    single = train_cli.main(['-opt', trainer_config(
        tmp_path, 'single', data, time_parallel=1), '--device', 'cpu'])
    start = init_state(build_model('deblur_small', **TINY), seed=0)
    got = {k: a0['params'][k] - start[k] for k in start}
    want = {k: v - start[k] for k, v in single.model.state_dict().items()}
    assert rel_l2(got, want) <= 1e-5
