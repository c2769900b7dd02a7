"""The training orchestrator of the port.

Counterpart of ``shiftnet_tpu/train/trainer.py:47-331`` (the reference's
``basicsr/train1.py`` / ``train2.py``): model + optimizer + step + loader +
checkpoints + logging + auto-resume + periodic visual dumps and validation,
from the same YAML configs.

- ``fused: true`` with bf16 trains the fused model (``fused_chw``): the
  kernels run the forward and the plain twins' autograd the backward
  (``ops/chw_grad``).  Otherwise (the default, as in JAX) the plain model
  under autograd.
- Parallelism (``trainer.py:66-140, :163-167``): under a launcher
  (torchrun, ``parallel/launch.py``) the ranks form a ``data x time``
  mesh, ``time = time_parallel`` and ``data = world size / time``.  The
  global batch is ``batch_size_per_device x data``; the sampler shards the
  clips by data rank, and the ranks of one time ring load the same clips
  and each trains on its frames (``train/step.py``).  Only the primary
  rank logs, dumps visuals, validates and writes checkpoints; every rank
  reads them on resume.
- The step's random draws (denoise noise, HEM) come from a generator keyed
  by (``manual_seed``, step), HEM's on a mesh also by the rank's data and
  time index; auto-resume fast-forwards the loader to the saved step, so a
  resumed run reproduces the uninterrupted one.
- ``device`` (default ``cuda``, a launched rank's own card) is where the
  model trains; ``cpu`` runs it on the plain versions.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from shiftnet_tpu_torch.data.loader import (DeviceStager, PrefetchLoader,
                                            staged_batches)
from shiftnet_tpu_torch.data.video_dataset import (ShardedEpochSampler,
                                                   VideoFolderDataset)
from shiftnet_tpu_torch.models import CONFIGS, build_model, init_params
from shiftnet_tpu_torch.parallel import mesh as pmesh
from shiftnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 save_params_npz)
from shiftnet_tpu_torch.train.optim import OptimConfig, build_optimizer
from shiftnet_tpu_torch.train.step import (TaskConfig, shard_generator,
                                           train_step)
from shiftnet_tpu_torch.utils.config import make_exp_dirs
from shiftnet_tpu_torch.utils.logging import TrainLogger, get_logger


class Trainer:
    def __init__(self, opt: dict[str, Any]):
        self.opt = opt
        self.time_parallel = int(opt.get('time_parallel', 1))
        world = pmesh.world_size()
        if world % self.time_parallel:
            raise ValueError(
                f'time_parallel {self.time_parallel} needs a multiple of '
                f'{self.time_parallel} ranks; this run has {world} (launch '
                f'it with torchrun --nproc_per_node N)')
        if int(opt['n_sequence']) % self.time_parallel:
            raise ValueError(  # shiftnet_tpu/train/trainer.py:96-99
                f'n_sequence {opt["n_sequence"]} must divide by '
                f'time_parallel {self.time_parallel}')
        self.mesh = pmesh.make_mesh(time=self.time_parallel)
        self.primary = pmesh.is_primary()
        if self.primary:
            make_exp_dirs(opt)
        self.logger = get_logger(
            f"shiftnet_torch:{os.path.abspath(opt['path']['log'])}",
            os.path.join(opt['path']['log'], 'train.log'),
            is_primary=self.primary)
        self.device = torch.device(opt.get('device', 'cuda'))

        variant = opt['model']
        bf16 = bool(opt.get('bf16', True))
        # Training predicts all-but-(fb, ff) frames; the fused model trains
        # only with bf16 (shiftnet_tpu/train/trainer.py:85-86).
        fused = bool(opt.get('fused', False)) and bf16
        mov = dict(opt.get('model_overrides') or {})
        mcfg = CONFIGS[variant].replace(**mov)
        if self.time_parallel > 1:
            # every rank predicts all of its frames; the loss masks the
            # global edge frames (train/step.py)
            mov.update(past_frames=0, future_frames=0,
                       time_group=self.mesh.time_group)
        self.model = build_model(variant, fused_chw=fused, **mov)
        self.seed = int(opt.get('manual_seed', 0))
        init_params(self.model, self.seed)
        self.model.to(self.device)
        self.task = TaskConfig(
            kind='denoise' if mcfg.noise_map else 'deblur',
            loss_spec=opt.get('loss_type', '1*L1'),
            center_slice=(mcfg.past_frames, mcfg.future_frames),
            dtype=torch.bfloat16 if bf16 else torch.float32)

        train_opt = opt['train']
        self.total_iters = int(train_opt['total_iter'])
        sched = train_opt['scheduler']
        self.optim_cfg = OptimConfig(
            lr=float(train_opt['optim_g']['lr']),
            betas=tuple(train_opt['optim_g'].get('betas', (0.9, 0.99))),
            weight_decay=float(train_opt['optim_g'].get('weight_decay', 0.0)),
            total_iters=int(sched.get('T_max', self.total_iters)),
            eta_min=float(sched.get('eta_min', 1e-7)),
            scheduler_kind=str(sched.get('type', 'cosine')),
            scheduler_kwargs={k: v for k, v in sched.items()
                              if k not in ('type', 'eta_min')},
            warmup_iter=int(train_opt.get('warmup_iter', -1)),
            grad_clip=train_opt.get('grad_clip', 0.01),
            lr_group_scales=train_opt.get('lr_group_scales', {}) or {})
        self.optimizer = build_optimizer(self.model, self.optim_cfg)
        self.batch_size = int(opt.get('batch_size_per_device', 1))
        m = self.mesh
        self.logger.info(
            f'{variant} on {self.device}: {"fused" if fused else "plain"}, '
            f'{self.task.dtype}, mesh data {m.data} x time {m.time}, '
            f'global batch {self.batch_size * m.data} '
            f'({self.batch_size} a data rank)')

        ds_opt = opt['datasets']['train']
        common = dict(n_seq=int(opt['n_sequence']),
                      patch_size=int(opt.get('patch_size', 256)),
                      size_must_mode=int(opt.get('size_must_mode', 4)),
                      augment=not opt.get('no_augment', False))
        deblur = self.task.kind == 'deblur'
        if ds_opt.get('packed_gt'):
            from shiftnet_tpu_torch.data.packed import PackedVideoDataset
            self.dataset = PackedVideoDataset(
                ds_opt['packed_gt'],
                ds_opt.get('packed_lq') if deblur else None, **common)
            self.logger.info(f'packed data, {self.dataset.reader} reader')
        else:
            self.dataset = VideoFolderDataset(
                ds_opt['dir_data'], gt_dir=ds_opt.get('gt_dir', 'gt'),
                lq_dir=ds_opt.get('lq_dir', 'blur') if deblur else None,
                n_frames_per_video=opt.get('n_frames_per_video'), **common)
        sampler = ShardedEpochSampler(
            len(self.dataset),
            ratio=int(ds_opt.get('dataset_enlarge_ratio', 1)),
            num_shards=m.data, shard=m.data_rank, seed=self.seed)
        self.loader = PrefetchLoader(
            self.dataset, sampler, batch_size=self.batch_size,
            num_threads=int(ds_opt.get('num_worker_per_gpu', 2)),
            seed=self.seed)
        self.steps_per_epoch = max(len(self.dataset) // self.batch_size, 1)

        self.ckpt = CheckpointManager(opt['path']['training_states'],
                                      max_to_keep=3, create=self.primary)
        if pmesh.initialized():
            dist.barrier()  # the primary made the directories
        self.step = 0
        state = self.ckpt.restore()
        if state is not None:
            self.model.load_state_dict(state['model'])
            self.optimizer.load_state_dict(state['optimizer'])
            self.step = int(state['step'])
            self.logger.info(f'auto-resumed from step {self.step}')
            # Fast-forward the batch stream (index arithmetic, no decode):
            # the resumed run consumes exactly the batches the uninterrupted
            # run would.
            self.loader.start_batch = self.step
        self._validator = None

    def generator(self, step: int) -> torch.Generator:
        """The step's random draws: keyed by (seed, step), as JAX folds the
        step into its key (``trainer.py:239``); the same on every rank."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed + 1) * 2 ** 32 + step)
        return gen

    def current_lr(self, step: int) -> float:
        return float(self.optimizer.schedule(step))

    def run(self):
        opt = self.opt
        log_cfg = opt.get('logger', {})
        print_freq = int(log_cfg.get('print_freq', 500))
        save_freq = int(log_cfg.get('save_checkpoint_freq', 10_000))
        visual_freq = int(log_cfg.get('visual_freq', 0))
        val_cfg = opt.get('val') or {}
        val_freq = int(float(val_cfg.get('val_freq', 0)))
        tlog = TrainLogger(self.logger, self.total_iters, self.step,
                           tb_dir=os.path.join(opt['path']['log'], 'tb')
                           if log_cfg.get('use_tb_logger') else None)
        stager = DeviceStager(self.device)
        self.model.train()
        it = self.step
        for host, staged in staged_batches(self.loader, stager.put):
            if it >= self.total_iters:
                break
            self.metrics = train_step(
                self.model, self.optimizer, self.task, stager.ready(staged),
                self.generator(it),
                mesh=self.mesh if pmesh.initialized() else None,
                loss_generator=shard_generator(self.seed, it, self.mesh,
                                               self.device))
            it += 1
            self.step = it
            if it % print_freq == 0 and self.primary:
                tlog(it, it // self.steps_per_epoch, self.current_lr(it),
                     {k: float(v) for k, v in self.metrics.items()})
            if visual_freq and it % visual_freq == 0 and self.primary:
                self.dump_visuals(it, host)
            if it % save_freq == 0:
                self.save(it)
            if val_freq and it % val_freq == 0 and self.primary:
                self.validate(it, val_cfg)
        self.loader.stop()
        self.save(it)
        self.logger.info('training complete')

    def validate(self, it: int, val_cfg: dict) -> dict:
        """Windowed evaluation on a held-out video folder through the port's
        ``Evaluator``, on the live weights; ``val.metrics`` dispatches by
        name through the metric registry (``eval/registry.py``)."""
        from shiftnet_tpu_torch.eval.runner import Evaluator
        state = self.model.state_dict()
        if self._validator is None:
            self._validator = Evaluator(
                self.opt['model'], state, device=self.device,
                result_path=os.path.join(self.opt['path']['log'], 'val'),
                bf16=self.task.dtype == torch.bfloat16,
                metrics=val_cfg.get('metrics'),
                overrides=self.opt.get('model_overrides'))
        ev = self._validator
        ev.model.load_state_dict(state)
        gkw = dict(grids=bool(val_cfg.get('grids', False)),
                   crop_size=int(val_cfg.get('crop_size', 256)),
                   trans_num=int(val_cfg.get('trans_num', 1)))
        if self.task.kind == 'denoise':
            res = ev.eval_denoise(val_cfg['dir_data'],
                                  float(val_cfg.get('sigma', 10.0)), **gkw)
        else:
            res = ev.eval_deblur(val_cfg['dir_data'],
                                 one_len=int(val_cfg.get('one_len', 16)),
                                 **gkw)
        self.logger.info(f'[val @ {it}] ' + ' '.join(
            f'{k.upper()} {v:.5g}' for k, v in res.items()
            if isinstance(v, float)))
        return res

    def whole_clip_model(self):
        """The model of a whole clip: ``self.model``, or on a time ring a
        copy without the ring that predicts all but the center slice's
        frames (``trainer.py``'s ``self.model`` beside ``_ts_model``)."""
        if self.model.cfg.time_group is None:
            return self.model
        fb, ff = self.task.center_slice
        twin = build_model(self.opt['model'],
                           fused_chw=self.model.cfg.fused_chw,
                           **dict(self.opt.get('model_overrides') or {},
                                  past_frames=fb, future_frames=ff))
        twin.load_state_dict(self.model.state_dict())
        return twin.to(self.device)

    def dump_visuals(self, it: int, batch: dict[str, np.ndarray]):
        """An (input, gt, output) PNG triplet of the first clip's center
        frame (reference ``train1.py:261-274``)."""
        from PIL import Image
        gt = batch['gt'][0]
        lq = batch.get('lq', batch['gt'])[0]
        fb, _ = self.task.center_slice
        x = torch.from_numpy(np.ascontiguousarray(lq)).permute(0, 3, 1, 2)
        x = x.to(self.device, self.task.dtype).contiguous()
        nm = None
        if self.task.kind == 'denoise':
            nm = torch.full((x.shape[0], 1, *x.shape[2:]), 25.0 / 255.0,
                            device=self.device, dtype=x.dtype)
        with torch.inference_mode():
            out = self.whole_clip_model()(x, nm).float().permute(
                0, 2, 3, 1).cpu().numpy()
        mid = out.shape[0] // 2
        d = self.opt['path']['visualization']
        os.makedirs(d, exist_ok=True)
        for name, img in (('input', lq[fb + mid]), ('gt', gt[fb + mid]),
                          ('output', out[mid])):
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(d, f'{it:08d}_{name}.png'))

    def save(self, it: int):
        """The checkpoint and the ``.npz`` export, on the primary rank."""
        if not self.primary:
            return
        self.ckpt.save(it, {'step': it, 'model': self.model.state_dict(),
                            'optimizer': self.optimizer.state_dict()})
        npz = os.path.join(self.opt['path']['models'], f'net_g_{it}.npz')
        save_params_npz(npz, self.model.state_dict())
        self.logger.info(f'saved checkpoint @ {it} -> {npz}')
