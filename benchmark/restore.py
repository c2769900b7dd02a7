"""The restore cells: whole windows (clips) through the program's entry,
``Evaluator.forward_window``, from host numpy in to host numpy out, as the
eval CLIs run them; the sampled clip's every window checked against the
plain reference."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator, harness, weights
from benchmark.flops import window_flops
from benchmark.reference import restore as ref
from benchmark.reference.model import Arch, GShiftNet
from benchmark.reference.window import plan_for

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


class Restore:
    rate_metric = 'restore_fps'
    span = 'forward_window'

    def __init__(self, cell, seed: int, device, workdir: str | None,
                 program: bool = True):
        """Set-up: the seeded weights and clips, and (``program``) the
        program's entry with one warm-up window.  Without ``program`` only
        the inputs are made (the controls)."""
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.halo = tr['halo']
        self.dtype = DTYPES[cfg['precision']['restore']]
        overrides = {k: v for k, v in cfg['model'].items()
                     if k not in ('past_frames', 'future_frames')}
        if program:
            from shiftnet_tpu_torch.eval.runner import (CONFIG_OVERRIDES,
                                                        Evaluator)
            from shiftnet_tpu_torch.models import build_model
            overrides.update(CONFIG_OVERRIDES[tr['configuration']])
            template = build_model(cfg['variant'], **overrides)
        else:
            template = GShiftNet(self.arch())
        shapes = {k: tuple(v.shape) for k, v in
                  template.state_dict().items()}
        del template
        self.state = weights.make_state(shapes, seed, device)
        self.pool = generator.restore_pool(tr, seed, device)
        t, self.h, self.w = self.pool[0].x.shape[:3]
        self.frames_per_unit = t - 2 * self.halo
        self.outputs: list[tuple[int, np.ndarray]] = []
        if not program:
            return
        if torch.device(device).type == 'cuda':
            self._load_kernels()
        self.ev = Evaluator(cfg['variant'], self.state, device=device,
                            result_path=workdir, overrides=overrides,
                            bf16=self.dtype == torch.bfloat16)
        self.plan = self.ev.window_plan(self.pool[0].x.shape)
        harness.log(f'{cell.name}: window {self.pool[0].x.shape} '
                    f'{self.dtype}, plan {self.plan}; pool of '
                    f'{len(self.pool)} clips, sigmas '
                    f'{[u.sigma for u in self.pool]}')
        self.ev.forward_window(self.pool[0].x, self.pool[0].sigma)  # warm-up
        harness.sync(device)

    @staticmethod
    def _load_kernels() -> None:
        """Load the program's kernel library, building it first in a fresh
        checkout (nvcc, keyed on the sources), and log how long that took:
        the cold build is part of the first run's ``setup_s``, and this
        line records it apart."""
        from shiftnet_tpu_torch.ops import _build
        cold = not _build.library_path().exists()
        t0 = time.time()
        _build.library()
        harness.log(f'kernel library {"built (cold)" if cold else "found"} '
                    f'in {time.time() - t0:.3f} s')

    def unit(self, i: int) -> None:
        k = generator.order(self.tr, self.seed, i)
        u = self.pool[k]
        self.outputs.append((k, self.ev.forward_window(u.x, u.sigma)))

    def release(self) -> None:
        del self.ev

    def arch(self) -> Arch:
        return Arch.from_config(self.cfg['model'], past_frames=self.halo,
                                future_frames=self.halo)

    def check(self, quant=None, tf32: bool = False,
              clip: int | None = None) -> dict[str, float]:
        """The worst rms and max gap of the sampled clip's windows to the
        reference's (the sample: a window of the run drawn from the seed,
        and every window of its clip).  ``quant`` / ``tf32``: the control
        (the reference in a lower precision in the program's place) and
        ``clip``: its clip."""
        model = ref.build(self.arch(), self.state, self.device)
        if clip is None:
            pick = generator.derive(self.seed, 'check') % len(self.outputs)
            clip = self.outputs[pick][0]
            outs = [o for k, o in self.outputs if k == clip]
        else:
            low = ref.build(self.arch(), self.state, self.device, quant)
            u = self.pool[clip]
            outs = [ref.restore(low, u.x, u.sigma, plan_for(self.h, self.w),
                                block=self.tr['reference_block'], tf32=tf32)]
            del low
        u = self.pool[clip]
        want = ref.restore(model, u.x, u.sigma, plan_for(self.h, self.w),
                           block=self.tr['reference_block'])
        rms = mx = 0.0
        for o in outs:
            d = (torch.as_tensor(o).to(want.device) - want).double()
            rms = max(rms, float(d.square().mean().sqrt()))
            mx = max(mx, float(d.abs().max()))
            del d
        res = want.double() - torch.from_numpy(
            u.x[self.halo:u.x.shape[0] - self.halo]).to(want.device)
        harness.log(f'check: clip {clip}, {len(outs)} windows compared; '
                    'reference rms of (out - input) '
                    f'{float(res.square().mean().sqrt()):.6g}')
        return {'rms_err': rms, 'max_err': mx}

    def flops(self, units: int) -> float:
        return units * window_flops(self.arch(), self.pool[0].x.shape[0],
                                    self.h, self.w, self.plan)

