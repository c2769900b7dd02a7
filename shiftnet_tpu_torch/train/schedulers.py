"""LR schedules as plain functions of the step.

Counterpart of ``shiftnet_tpu/train/schedulers.py``: the reference
scheduler family (``basicsr/models/lr_scheduler.py`` and torch
``CosineAnnealingLR`` as ``TrueCosineAnnealingLR``, ``base_model.py:82-113``)
plus the linear warmup of ``base_model.py:163-185``.  Each is a host
function ``step -> lr`` in float64; the optimizer sets every param group's
LR from it before an update.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def true_cosine_annealing(lr: float, t_max: int,
                          eta_min: float = 0.0) -> Schedule:
    """torch ``CosineAnnealingLR`` (closed form)."""
    def fn(step):
        t = min(step, t_max)
        return eta_min + (lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t
                                                              / t_max))
    return fn


def cosine_annealing_restart(lr: float, periods: Sequence[int],
                             restart_weights: Sequence[float] = (1,),
                             eta_min: float = 0.0) -> Schedule:
    """``CosineAnnealingRestartLR`` (``lr_scheduler.py:140-185``)."""
    if len(periods) != len(restart_weights):
        raise ValueError('periods and restart_weights differ in length')
    cum = [sum(periods[:i + 1]) for i in range(len(periods))]

    def fn(step):
        out = None
        prev = 0
        for period, weight, bound in zip(periods, restart_weights, cum):
            t = min(max(step - prev, 0), period)
            val = eta_min + weight * 0.5 * (lr - eta_min) * (
                1 + math.cos(math.pi * t / period))
            out = val if out is None or step > prev - 1 else out
            prev = bound
        return out

    return fn


def multi_step_restart(lr: float, milestones: Sequence[int],
                       gamma: float = 0.1, restarts: Sequence[int] = (0,),
                       restart_weights: Sequence[float] = (1,)) -> Schedule:
    """``MultiStepRestartLR`` (``lr_scheduler.py:12-52``): step decay by
    ``gamma`` at each milestone, reset to ``weight * lr`` at restarts."""
    if len(restarts) != len(restart_weights):
        raise ValueError('restarts and restart_weights differ in length')

    def fn(step):
        base = 1.0
        last_restart = 0
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                base, last_restart = w, r
        decay = sum(1 for m in milestones if step >= m > last_restart)
        return lr * base * gamma ** decay

    return fn


def linear_decay(lr: float, total_iter: int) -> Schedule:
    """``LinearLR`` (``lr_scheduler.py:54-76``)."""
    return lambda step: lr * (1.0 - step / total_iter)


def vibrate(lr: float, total_iter: int) -> Schedule:
    """``VibrateLR`` (``lr_scheduler.py:78-117``): triangular oscillation
    under a piecewise-decaying envelope."""
    T = total_iter // 80
    Th = T // 2

    def fn(step):
        process = step / total_iter
        f = 1 - process * 8 / 3 if process < 3 / 8 else (
            0.2 if process < 5 / 8 else 0.1)
        t = step % T
        f2 = 2 - t / Th if t >= Th else t / Th
        weight = f * f2
        if step < Th:
            weight = max(weight, 0.1)
        return lr * weight

    return fn


def with_warmup(schedule: Schedule, warmup_iter: int, lr: float) -> Schedule:
    """Linear warmup (``base_model.py:163-185``): lr ramps 0 -> base over
    ``warmup_iter`` steps, then hands off to the base schedule."""
    if warmup_iter <= 0:
        return schedule
    return lambda step: (lr * (step / warmup_iter) if step < warmup_iter
                         else schedule(step))


def build_schedule(kind: str, lr: float, total_iter: int, *,
                   eta_min: float = 0.0, warmup_iter: int = -1,
                   **kw) -> Schedule:
    kind = kind.lower()
    if kind in ('cosine', 'truecosineannealinglr'):
        s = true_cosine_annealing(lr, kw.get('T_max', total_iter), eta_min)
    elif kind == 'cosineannealingrestartlr':
        s = cosine_annealing_restart(lr, kw['periods'],
                                     kw.get('restart_weights', (1,)), eta_min)
    elif kind in ('multisteplr', 'multistepreartlr', 'multisteprestartlr'):
        s = multi_step_restart(lr, kw['milestones'], kw.get('gamma', 0.1),
                               kw.get('restarts', (0,)),
                               kw.get('restart_weights', (1,)))
    elif kind == 'linearlr':
        s = linear_decay(lr, total_iter)
    elif kind == 'vibratelr':
        s = vibrate(lr, total_iter)
    else:
        raise ValueError(f'unknown scheduler {kind}')
    return with_warmup(s, warmup_iter, lr)
