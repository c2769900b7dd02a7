"""Training logger: console + file + optional TensorBoard.

The port's own copy of ``shiftnet_tpu/utils/logging.py``.  Replaces the
reference ``MessageLogger`` / ``get_root_logger``
(``basicsr/utils/logger.py:14-155``): rank-0-only file handler,
iter/lr/eta/loss formatting, TB scalars when tensorboard is importable
(skipped otherwise), and an optional wandb run.
"""
from __future__ import annotations

import logging
import os
import sys
import time


def get_logger(name: str = 'shiftnet', log_file: str | None = None,
               is_primary: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO if is_primary else logging.ERROR)
    fmt = logging.Formatter('%(asctime)s %(levelname)s: %(message)s')
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and is_primary:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        fh = logging.FileHandler(log_file, 'a')
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def init_wandb(opt: dict, logger: logging.Logger | None = None):
    """Weights & Biases run init with TensorBoard sync, mirroring the
    reference ``init_wandb_logger`` (``basicsr/utils/logger.py:92-116``):
    resumes the run id from ``logger.wandb.resume_id`` when set, otherwise
    starts a fresh run.  Gracefully a no-op when wandb isn't installed or no
    project is configured.

    Config surface (same keys as the reference yml)::

        logger:
          wandb:
            project: my-project
            resume_id: ~
    """
    wcfg = (opt.get('logger') or {}).get('wandb') or {}
    project = wcfg.get('project')
    if not project:
        return None
    try:
        import wandb
    except ImportError:
        if logger:
            logger.warning('wandb requested in config but not installed; '
                           'skipping wandb logging')
        return None
    resume_id = wcfg.get('resume_id')
    if resume_id:
        run = wandb.init(id=resume_id, resume='allow', name=opt.get('name'),
                         config=opt, project=project, sync_tensorboard=True)
        if logger:
            logger.warning(f'Resume wandb logger with id={resume_id}.')
    else:
        run = wandb.init(name=opt.get('name'), config=opt, project=project,
                         sync_tensorboard=True)
    if logger:
        logger.info(f'Use wandb logger with id={run.id}; project={project}.')
    return run


class TrainLogger:
    """Formats per-iteration training messages with lr/eta/losses and pushes
    scalars to TensorBoard if available."""

    def __init__(self, logger: logging.Logger, total_iters: int,
                 start_iter: int = 0, tb_dir: str | None = None):
        self.logger = logger
        self.total_iters = total_iters
        self.start_iter = start_iter
        self.start_time = time.time()
        self.tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(tb_dir)
            except Exception:
                self.tb = None

    def __call__(self, it: int, epoch: int, lr: float, metrics: dict,
                 extra: str = ''):
        elapsed = time.time() - self.start_time
        done = max(it - self.start_iter, 1)
        eta = elapsed / done * (self.total_iters - it)
        msg = (f'[epoch {epoch:3d}] iter {it:8,d} lr {lr:.3e} '
               + ' '.join(f'{k}: {float(v):.4e}' for k, v in metrics.items())
               + f' eta {eta / 3600:.1f}h {extra}')
        self.logger.info(msg)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f'train/{k}', float(v), it)
            self.tb.add_scalar('train/lr', lr, it)
