"""The port's data- and sequence-parallel train steps on CPU ranks
(``torch.distributed``, gloo) against one process and the JAX package.

One spawn of 4 ranks (``parallel/launch.run``, ``parallel/workers.py``)
runs every case: the sequence-parallel step on a 2 data x 2 time mesh for
deblur_small and denoise_small (Encoder2's level-0 ShiftCABs on, so their
sharded shift runs beside the shift blocks'), ``shift_rounds=2``, unfused
and fused (on the CPU the kernels' plain versions forward, the plain
twins backward); and the data-parallel step on 4 x 1.  Widths are
``tests/test_multichip.py``'s ``TINY``.

- Every case against the port's single-process step on the same global
  batch and draws: gradients to 1e-6 relative L2, grad norm and loss to
  1e-6; all ranks end on the same weights.  So are deblur_small's
  sequence-parallel steps under the other loss terms ('1*L1+1*PSNR',
  '1*MSE'); under '1*L1+1*HEM', whose random mask each rank draws from its
  own key (``step.shard_generator``), the step is held to the sharded
  formula of ``make_tsharded_train_step`` (``shiftnet_tpu/train/step.py:
  187-207``) computed here on the same per-shard masks.
- denoise_small, the case that runs every exchange (ShiftCAB and shift
  block, forward and reverse) and the noise draws, against JAX's unfused
  single-device step (``make_train_step``) at ``tests/test_multichip.py:
  152-157``'s bounds: loss to rtol 1e-5, the weights after one AdamW step
  to rtol 2e-4 / atol 2e-6.  JAX's step compiles in about 140 s on this
  CPU (deblur_small's in about 95 s), so deblur_small is held to JAX
  through the port's single process, which ``tests/test_torch_train.py``
  holds to JAX's step.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shiftnet_tpu.models import build_model as jax_build_model
from shiftnet_tpu.tools.convert_torch import torch_state_to_flax
from shiftnet_tpu.train.optim import OptimConfig as JaxOptimConfig
from shiftnet_tpu.train.optim import build_optimizer as jax_optimizer
from shiftnet_tpu.train.step import TaskConfig as JaxTask
from shiftnet_tpu.train.step import TrainState, make_train_step
from shiftnet_tpu_torch.models import CONFIGS, build_model, init_state
from shiftnet_tpu_torch.parallel import launch, workers
from shiftnet_tpu_torch.parallel.mesh import Mesh
from shiftnet_tpu_torch.train import optim
from shiftnet_tpu_torch.train.step import shard_generator
from shiftnet_tpu_torch.tools.convert import state_from_jax

CPU = jax.devices('cpu')[0]
TINY = dict(n_feats0=8, n_feats2=16, num_orbs=1, tfr_scale=4,
            shift_rounds=2, encoder2_levels=2)
T, B, P = 8, 2, 16
VARIANTS = {'deblur': ('deblur_small', {}),
            'denoise': ('denoise_small',
                        dict(encoder2_level0_shift_cabs=True))}
CASES = [(kind, fused) for kind in VARIANTS for fused in (False, True)]
IDS = [f'{k}-{"fused" if f else "unfused"}' for k, f in CASES]
LOSS_SPECS = ['1*L1+1*PSNR', '1*MSE']
HEM_SPEC = '1*L1+1*HEM'
KEY = jax.random.PRNGKey(7)  # JAX's step key, whose noise both steps take


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def overrides(kind):
    return dict(TINY, **VARIANTS[kind][1])


def rel_l2(a, b):
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    return np.sqrt(num / sum(float(b[k].double().square().sum())
                             for k in b))


def jax_draws(key, shape):
    """The sigma and noise JAX's step draws (``shiftnet_tpu/train/
    step.py:62-67``), in the port's layout."""
    rng_sigma, rng_noise, _ = jax.random.split(key, 3)
    lo, hi = JaxTask().sigma_range
    sigma = jax.random.uniform(rng_sigma, (shape[0], 1, 1, 1, 1), minval=lo,
                               maxval=hi)
    noise = jax.random.normal(rng_noise, shape) * sigma
    return (torch.from_numpy(np.array(sigma).reshape(shape[0])),
            torch.from_numpy(np.array(noise).transpose(0, 1, 4, 2, 3)
                             .copy()))


@pytest.fixture(scope='module')
def inputs():
    """Per kind: weights, the global batch (B, T, 3, H, W) and, for
    denoise, the draws of JAX's step under ``KEY``."""
    out = {}
    for kind, (variant, _) in VARIANTS.items():
        state = init_state(build_model(variant, **overrides(kind)), seed=9)
        rng = np.random.default_rng(0)
        shape = (B, T, P, P, 3)
        batch = {'gt': rng.uniform(0, 1, shape).astype(np.float32)}
        if kind == 'deblur':
            batch['lq'] = rng.uniform(0, 1, shape).astype(np.float32)
        with jax.default_device(CPU):
            draws = jax_draws(KEY, shape) if kind == 'denoise' else None
        out[kind] = dict(variant=variant, state=state, draws=draws,
                         nhwc=batch,
                         batch={k: torch.from_numpy(
                             v.transpose(0, 1, 4, 2, 3).copy())
                             for k, v in batch.items()})
    return out


@pytest.fixture(scope='module')
def runs(inputs):
    """Every case on 4 ranks, in one spawn; and the data-parallel step on
    a global batch of 4 (the deblur batch and its frames reversed)."""
    jobs = [('train_steps', (inputs[k]['variant'], overrides(k),
                             inputs[k]['state'], inputs[k]['batch'],
                             inputs[k]['draws']),
             dict(data=2, time_=2, fused=fused)) for k, fused in CASES]
    inp = inputs['deblur']
    specs = LOSS_SPECS + [HEM_SPEC]
    jobs += [('train_steps', ('deblur_small', overrides('deblur'),
                              inp['state'], inp['batch'], None),
              dict(data=2, time_=2, loss_spec=spec)) for spec in specs]
    dp_batch = {k: torch.cat([v, v.flip(1)]) for k, v in inp['batch'].items()}
    jobs.append(('train_steps', ('deblur_small', overrides('deblur'),
                                 inp['state'], dp_batch, None),
                 dict(data=4, time_=1)))
    ranks = launch.run(workers.run_jobs, 4, jobs)
    res = [list(r) for r in zip(*ranks)]
    n = len(CASES)
    return (dict(zip(CASES, res[:n])) | dict(zip(specs, res[n:-1]))
            | {'dp': (res[-1], dp_batch)})


@pytest.fixture(scope='module')
def one_process(inputs):
    """The port's single-process step on each case's global batch."""
    return {(k, fused): workers.train_steps(
        inputs[k]['variant'], overrides(k), inputs[k]['state'],
        inputs[k]['batch'], inputs[k]['draws'], data=1, time_=1, fused=fused)
        for k, fused in CASES}


@pytest.fixture(scope='module')
def hem_reference(inputs):
    """The sharded step's loss and gradients under ``HEM_SPEC`` by
    ``make_tsharded_train_step``'s formula, here in one process: the
    deblur model that predicts every frame, the L1 sum and the HEM sums
    over the global center slice, HEM's mask drawn per (data, time) shard
    from the key that rank draws from, both over the global count."""
    inp = inputs['deblur']
    cfg = CONFIGS['deblur_small'].replace(**overrides('deblur'))
    fb, ff = cfg.past_frames, cfg.future_frames
    model = build_model('deblur_small', past_frames=0, future_frames=0,
                        **overrides('deblur'))
    model.load_state_dict(inp['state'])
    batch = inp['batch']
    d = torch.stack([model(c) for c in batch['lq']]) - batch['gt']
    g = torch.arange(T)
    m = ((g >= fb) & (g < T - ff)).float().view(1, T, 1, 1, 1)
    total = (d.abs() * m).sum()
    b, t = B // 2, T // 2
    for dr in range(2):
        for tr in range(2):
            gen = shard_generator(0, 0, Mesh(2, 2, dr, tr, None, None),
                                  'cpu')
            rows, frames = slice(dr * b, dr * b + b), slice(tr * t,
                                                            tr * t + t)
            err = d[rows, frames].abs()
            total = total + (err * optim.hem_mask(err, generator=gen)
                             * m[:, frames]).sum()
    loss = total / ((T - fb - ff) * B * 3 * P * P)
    loss.backward()
    return float(loss.detach()), {k: p.grad.double()
                         for k, p in model.named_parameters()}


@pytest.fixture(scope='module')
def jax_denoise(inputs):
    """JAX's unfused single-device denoise step on the same weights and
    batch: its loss and its weights after one step, by torch key."""
    inp = inputs['denoise']
    jmodel = jax_build_model(inp['variant'], **overrides('denoise'))
    task = JaxTask(kind='denoise', center_slice=(0, 0))
    with jax.default_device(CPU):
        tpl = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((T, P, P, 3)),
            jnp.zeros((T, P, P, 1))))
        params = jax.tree.map(jnp.asarray, torch_state_to_flax(
            {k: v.numpy() for k, v in inp['state'].items()}, tpl['params']))
        tx = jax_optimizer(JaxOptimConfig(total_iters=10, grad_clip=0.01),
                           params)
        state, metrics = jax.jit(make_train_step(jmodel, tx, task))(
            TrainState.create(params, tx),
            {k: jnp.asarray(v) for k, v in inp['nhwc'].items()}, KEY)
        new = jax.device_get(state.params)
    return float(metrics['loss']), {
        k: v.numpy() for k, v in state_from_jax(new).items()}


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_sequence_parallel_gradients_match_one_process(runs, one_process,
                                                       case):
    got, one = runs[case][0], one_process[case]
    assert rel_l2(got['grads'], one['grads']) <= 1e-6
    assert abs(got['grad_norm'] - one['grad_norm']) <= (
        1e-6 * one['grad_norm'])
    assert abs(got['loss'] - one['loss']) <= 1e-6 * one['loss']


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_sequence_parallel_ranks_end_on_the_same_weights(runs,
                                                         one_process, case):
    ranks = runs[case]
    for r in ranks[1:]:
        assert all(torch.equal(r['params'][k], ranks[0]['params'][k])
                   for k in ranks[0]['params'])
    assert rel_l2(ranks[0]['params'], one_process[case]['params']) <= 1e-6


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_sequence_parallel_denoise_loss_matches_jax(runs, jax_denoise, fused):
    loss, _ = jax_denoise
    assert np.isclose(runs['denoise', fused][0]['loss'], loss, rtol=1e-5)


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_sequence_parallel_denoise_step_matches_jax(runs, jax_denoise,
                                                    fused):
    _, want = jax_denoise
    got = runs['denoise', fused][0]['params']
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=2e-4, atol=2e-6,
                                   err_msg=k)


def test_data_parallel_step_matches_one_process(inputs, runs):
    ranks, batch = runs['dp']
    one = workers.train_steps('deblur_small', overrides('deblur'),
                              inputs['deblur']['state'], batch, None,
                              data=1, time_=1)
    got = ranks[0]
    assert all(torch.equal(r['params'][k], got['params'][k])
               for r in ranks[1:] for k in got['params'])
    assert abs(got['loss'] - one['loss']) <= 1e-6 * one['loss']
    assert rel_l2(got['grads'], one['grads']) <= 1e-6
    assert rel_l2(got['params'], one['params']) <= 1e-6


@pytest.mark.parametrize('spec', LOSS_SPECS)
def test_sequence_parallel_loss_terms_match_one_process(inputs, runs, spec):
    one = workers.train_steps('deblur_small', overrides('deblur'),
                              inputs['deblur']['state'],
                              inputs['deblur']['batch'], None, data=1,
                              time_=1, loss_spec=spec)
    got = runs[spec][0]
    assert all(torch.equal(r['params'][k], got['params'][k])
               for r in runs[spec][1:] for k in got['params'])
    assert abs(got['loss'] - one['loss']) <= 1e-6 * abs(one['loss'])
    assert rel_l2(got['grads'], one['grads']) <= 1e-6
    assert rel_l2(got['params'], one['params']) <= 1e-6


def test_sequence_parallel_hem_matches_the_sharded_formula(runs,
                                                           hem_reference):
    loss, grads = hem_reference
    got = runs[HEM_SPEC][0]
    assert abs(got['loss'] - loss) <= 1e-6 * loss
    assert rel_l2(got['grads'], grads) <= 1e-6


def test_hem_keys_are_per_shard_and_reproducible():
    """``shard_generator``: one key a (data rank, time rank, step), the
    same draws for the same key; none in one process."""
    def draws(d, t, step):
        gen = shard_generator(3, step, Mesh(2, 2, d, t, None, None), 'cpu')
        return torch.rand(16, generator=gen)

    keys = [(d, t, s) for d in range(2) for t in range(2) for s in range(2)]
    got = {k: draws(*k) for k in keys}
    assert all(not torch.equal(got[a], got[b])
               for a in keys for b in keys if a != b)
    assert all(torch.equal(draws(*k), got[k]) for k in keys)
    assert shard_generator(3, 0, Mesh(1, 1, 0, 0, None, None), 'cpu') is None
