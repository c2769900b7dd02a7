"""Rank functions for ``parallel/launch.run``: the port's side of the
checks of its parallel paths.

``tests/test_torch_parallel.py`` and ``chip_smoke.py`` start them on N
ranks and hold what they return against the same computation in one
process (and, in the tests, against the JAX package).  They live in the
package, so a spawned rank imports them without importing a test module
or JAX.  Each takes whole inputs (the clip, the batch, the weights), cuts
its own shard, and returns CPU tensors.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from shiftnet_tpu_torch.parallel import mesh as pmesh


def _device() -> torch.device:
    return pmesh.rank_device('cuda' if torch.cuda.is_available() else 'cpu')


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _launches():
    from shiftnet_tpu_torch.ops import chw
    return dict(chw.LAUNCHES)


def _reset_launches():
    from shiftnet_tpu_torch.ops import chw
    chw.reset_launches()


def collectives(p2p: bool = False) -> dict:
    """Which collectives this rank's backend takes with tensors on its
    device, each checked against the values the ranks sent: the
    ``all_gather`` the ring exchange uses (bytes and bf16), an
    ``all_reduce``, and with ``p2p`` point-to-point ``send`` / ``recv``
    around the ring (which a backend may fail by crashing the rank: run it
    on ranks of its own).  'ok', 'wrong' or the error raised."""
    dev = _device()
    n, r = dist.get_world_size(), dist.get_rank()
    ops = {}

    def check(name, fn):
        try:
            ops[name] = 'ok' if fn() else 'wrong'
        except Exception as e:  # a backend refuses: reported, not fatal
            ops[name] = f'{type(e).__name__}: {str(e).splitlines()[0][:120]}'

    def gather(dtype):
        x = torch.full((4,), r + 1, device=dev).to(dtype)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    def reduce():
        x = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == n * (n + 1) / 2).all())

    def send_recv():
        x = torch.full((4,), float(r), device=dev)
        y = torch.empty_like(x)
        reqs = [dist.isend(x, (r + 1) % n), dist.irecv(y, (r - 1) % n)]
        for q in reqs:
            q.wait()
        return bool((y == (r - 1) % n).all())

    check('all_gather uint8', lambda: gather(torch.uint8))
    check('all_gather bfloat16', lambda: gather(torch.bfloat16))
    check('all_reduce float32', reduce)
    if p2p:
        check('send/recv float32', send_recv)
    dist.barrier()
    return {'backend': dist.get_backend(), 'device': str(dev), 'ops': ops}


def shift_cases(x: torch.Tensor, cot: torch.Tensor, xg: torch.Tensor,
                cots: tuple[torch.Tensor, torch.Tensor],
                cases: list[tuple[bool, bool]]) -> dict:
    """For each (reverse, boundary_patch) case: the sharded
    ``temporal_channel_shift`` of this rank's frames of x (T, C, H, W) and
    the gradient of sum(y * cot) with respect to them; and the sharded
    GSTS round (``gsts`` with ``ring_edge``, number 1) of the rank's frames
    of xg, its y and hw, and the gradient of sum(y * cots[0] + hw *
    cots[1]).  Then the ring exchange alone (each rank sends its rank
    index to both neighbours)."""
    from shiftnet_tpu_torch.ops.shift import gsts, temporal_channel_shift
    from shiftnet_tpu_torch.parallel.temporal import exchange
    n, r = dist.get_world_size(), dist.get_rank()
    t = x.shape[0] // n
    sl = slice(r * t, (r + 1) * t)
    group = dist.group.WORLD
    out = {}
    for reverse, patch in cases:
        xl = x[sl].clone().requires_grad_(True)
        y = temporal_channel_shift(xl, reverse=reverse, boundary_patch=patch,
                                   group=group)
        (y * cot[sl]).sum().backward()
        xr = xg[sl].clone().requires_grad_(True)
        yg, hw = gsts(xr, 1, reverse=reverse, boundary_patch=patch,
                      group=group)
        ((yg * cots[0][sl]).sum() + (hw * cots[1][sl]).sum()).backward()
        out[reverse, patch] = (y.detach(), xl.grad)
        out['gsts', reverse, patch] = (yg.detach(), hw.detach(), xr.grad)
    me = torch.full((2,), float(r), requires_grad=True)
    got = exchange(group, (1, -1), me * 1, me * 10)
    (got[0].sum() + 2 * got[1].sum()).backward()
    out['exchange'] = (tuple(g.detach() for g in got), me.grad)
    return out


def tp_forward(variant: str, overrides: dict, state: dict, x: torch.Tensor,
               noise_map: torch.Tensor | None, halo: int) -> torch.Tensor:
    """``temporal_parallel_forward`` of ``variant`` (past = future =
    ``halo``) on this rank's even share of x (T, 3, H, W): its frames'
    outputs."""
    from shiftnet_tpu_torch.models import build_model
    from shiftnet_tpu_torch.parallel.temporal import (
        shard_bounds, temporal_parallel_forward)
    dev = _device()
    model = build_model(variant, past_frames=halo, future_frames=halo,
                        **overrides)
    model.load_state_dict(state)
    model.to(dev).eval()
    s, e = shard_bounds(x.shape[0], dist.get_world_size())[dist.get_rank()]
    fwd = temporal_parallel_forward(model, dist.group.WORLD, halo)
    with torch.inference_mode():
        nm = None if noise_map is None else noise_map[s:e].to(dev)
        return fwd(x[s:e].to(dev), nm).float().cpu()


def evaluator_windows(variant: str, state: dict, windows: list,
                      **kw) -> dict:
    """``Evaluator(variant, tp=world).forward_window`` on each (window,
    sigma) of ``windows``, with each call's seconds, kernel launches and
    this rank's peak; then the two paths that must raise under tp (the
    grids forward and the quadrant plan) on the first window."""
    from shiftnet_tpu_torch.eval.runner import Evaluator
    dev = _device()
    with tempfile.TemporaryDirectory() as tmp:
        ev = Evaluator(variant, state, device=dev, result_path=tmp,
                       tp=dist.get_world_size(), **kw)
        res = {'outs': [], 'launches': [], 'seconds': [], 'peaks': []}
        for x, sigma in windows:
            _sync(dev)
            if dev.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t0 = time.perf_counter()
            out = ev.forward_window(x, sigma)
            _sync(dev)
            res['seconds'].append(time.perf_counter() - t0)
            res['launches'].append(_launches())
            res['peaks'].append(torch.cuda.max_memory_allocated(dev)
                                if dev.type == 'cuda' else None)
            res['outs'].append(torch.from_numpy(out) if ev.primary else None)
        # a 64x48 window has quadrant tiles; both calls raise before any
        # forward
        x = np.zeros((windows[0][0].shape[0], 64, 48, 3), np.float32)
        sigma = windows[0][1]
        raised = []
        for call in (lambda: ev.forward_grids(x, sigma, crop_size=16),
                     lambda: ev.forward_window(x, sigma, quadrant=True)):
            try:
                call()
            except ValueError as e:
                raised.append(str(e))
        res['raised'] = raised
        if ev.primary:
            res['log'] = open(ev.logger.path).read()
    return res


def train_steps(variant: str, overrides: dict, state: dict, batch: dict,
                draws, *, data: int, time_: int, fused: bool = False,
                loss_spec: str = '1*L1') -> dict:
    """One float32 step of ``train/step.train_step`` on a ``data x time_``
    mesh: data rank d trains on clips ``[d * b, (d + 1) * b)`` of the
    global ``batch`` ({'gt', 'lq'}: (B, T, 3, H, W)), and on a time ring
    (``time_ > 1``) the model is built on the ring.  ``draws``: the global
    batch's denoise (sigma (B,), noise (B, T, 3, H, W)), cut to the rank's
    clips and frames.  HEM's random mask draws from
    ``step.shard_generator(0, 0, mesh)`` (none in one process).  Returns
    the step's loss, grad norm and gradients, and the parameters after
    it."""
    from shiftnet_tpu_torch.models import CONFIGS, build_model
    from shiftnet_tpu_torch.train import optim
    from shiftnet_tpu_torch.train.step import (TaskConfig, shard_generator,
                                               train_step)
    dev = _device()
    m = pmesh.make_mesh(data, time_)
    mcfg = CONFIGS[variant].replace(**overrides)
    kw = dict(overrides)
    if time_ > 1:
        kw.update(past_frames=0, future_frames=0, time_group=m.time_group)
    if dev.type == 'cuda':  # float32 is float32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(variant, fused_chw=fused, **kw)
    model.load_state_dict(state)
    model.to(dev)
    task = TaskConfig(kind='denoise' if mcfg.noise_map else 'deblur',
                      loss_spec=loss_spec,
                      center_slice=(mcfg.past_frames, mcfg.future_frames))
    opt = optim.build_optimizer(model, optim.OptimConfig(
        lr=4e-4, total_iters=10, grad_clip=0.01))
    b = batch['gt'].shape[0] // data
    rows = slice(m.data_rank * b, (m.data_rank + 1) * b)
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    mine = None
    if draws is not None:
        t = batch['gt'].shape[1] // time_
        frames = slice(m.time_rank * t, (m.time_rank + 1) * t)
        mine = (draws[0][rows].to(dev), draws[1][rows, frames].to(dev))
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    metrics = train_step(model, opt, task, local, None, draws=mine, mesh=m,
                         loss_generator=shard_generator(0, 0, m, dev))
    _sync(dev)
    res = dict(loss=float(metrics['loss']),
               grad_norm=float(metrics['grad_norm']),
               grads={k: p.grad.detach().double().cpu()
                      for k, p in model.named_parameters()},
               launches=_launches(), seconds=time.perf_counter() - t0,
               params={k: v.detach().cpu()
                       for k, v in model.state_dict().items()})
    if dev.type == 'cuda':
        res['peak'] = torch.cuda.max_memory_allocated(dev)
    return res


def train_cli(config_path: str, steps_to: list[int], device: str) -> dict:
    """``tools/train.main`` on ``config_path`` once for each total step
    count of ``steps_to`` (the later runs resume), each step fenced and
    timed; returns every run's step seconds, losses, gradient norms and
    launches, the weight exports this rank wrote, its peak, and the final
    parameters."""
    import yaml

    from shiftnet_tpu_torch.tools import train as train_cli_mod
    from shiftnet_tpu_torch.train import trainer as trainer_mod
    dev = _device() if device == 'cuda' else torch.device(device)
    step, export = trainer_mod.train_step, trainer_mod.save_params_npz
    runs, saves = [], []

    def timed(*args, **kw):
        _sync(dev)
        _reset_launches()
        t0 = time.perf_counter()
        metrics = step(*args, **kw)
        _sync(dev)
        runs[-1]['seconds'].append(time.perf_counter() - t0)
        runs[-1]['losses'].append(float(metrics['loss']))
        runs[-1]['grad_norms'].append(float(metrics['grad_norm']))
        runs[-1]['launches'] = _launches()
        return metrics

    def counted(path, state):
        saves.append(path)
        return export(path, state)

    trainer_mod.train_step = timed
    trainer_mod.save_params_npz = counted
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        for total in steps_to:
            with open(config_path) as f:
                opt = yaml.safe_load(f)
            opt['train']['total_iter'] = total
            path = f'{config_path}.{total}.rank{dist.get_rank()}.yml'
            with open(path, 'w') as f:
                yaml.safe_dump(opt, f)
            runs.append({'seconds': [], 'losses': [], 'grad_norms': []})
            tr = train_cli_mod.main(['-opt', path, '--device', device])
            runs[-1]['step'] = tr.step
            runs[-1]['primary'] = tr.primary
            runs[-1]['mesh'] = (tr.mesh.data, tr.mesh.time)
    finally:
        trainer_mod.train_step = step
        trainer_mod.save_params_npz = export
    return {'runs': runs, 'saves': saves,
            'peak': (torch.cuda.max_memory_allocated(dev)
                     if dev.type == 'cuda' else None),
            'params': {k: v.detach().cpu()
                       for k, v in tr.model.state_dict().items()},
            'backend': dist.get_backend()}


def run_jobs(jobs: list[tuple]) -> list:
    """Several rank functions in turn on the same ranks (one spawn and one
    process group for all): ``jobs`` holds ``(name, args, kwargs)`` with
    ``name`` a function of this module; the device's cache is emptied
    between them."""
    out = []
    for name, args, kwargs in jobs:
        out.append(globals()[name](*args, **kwargs))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out
