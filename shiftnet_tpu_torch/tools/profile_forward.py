"""Where the time and the memory of one window go, on the GPU.

  python -m shiftnet_tpu_torch.tools.profile_forward \
      [--variant {deblur_plus,deblur_small,denoise_plus,denoise_small}] \
      [--config {fused_chw,conv_concat,fused_tfr,plain} ...] [--grids CROP]

For each configuration given (default ``fused_chw``, the Evaluator's: every
kernel of the port but conv_cat; ``conv_concat``: also conv_cat at rconcat
and conv_hr0; ``fused_tfr``: the TFR U-Nets' kernels only; ``plain``: none),
on seeded weights and a seeded window in the variant's default type
(deblur_plus and deblur_small: 40x720x1280 bf16, the ``bench.py``
protocol; denoise_plus and denoise_small: 16x480x848 float32 at sigma
10/255, the ``bench_denoise.py`` protocol), runs
the port's ``Evaluator.forward_window`` once to warm up, then:

1. once with CUDA events around every stage of the model (the top-level
   modules of ``GShiftNet`` and of its ``Encoder2``, the ShiftCABs
   included), printing each stage's device time and the peak device memory
   from the end of the stage before to the end of this one;
2. once under ``torch.profiler``, printing the wall time, the device-busy
   share of it (the union of kernel intervals), the device time of the
   port's kernels (``ops/chw``, ``ops/naf_chw``) against everything else,
   each port kernel's time, launches and share of the kernel time (every
   instantiation and form of it summed), and the top kernels.

``--grids CROP`` runs each window through ``Evaluator.forward_grids`` in
CROP-sized crops (one transform) in place of ``forward_window``: stage
times and launches are summed over the crops.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from shiftnet_tpu_torch.eval.runner import (CONFIG_OVERRIDES, Evaluator,
                                            configuration)
from shiftnet_tpu_torch.models import build_model, init_state

OUR_KERNELS = ('cab_front', 'cab_back', 'conv', 'up_skip', 'shift_round',
               'naf_gate', 'naf_rep', 'naf_back', 'conv_cat')
# A CUDA kernel's name -> the port kernel it belongs to (the tensor-core
# kernels launch <name>_mma_kernel, the others <name>_kernel).
_PORT_NAME = re.compile(r'shiftnet::(\w+?)(?:_mma)?_kernel\b')


def port_kernel(name: str) -> str | None:
    m = _PORT_NAME.search(name)
    return m.group(1) if m and m.group(1) in OUR_KERNELS else None


WINDOWS = {'deblur_plus': ((40, 720, 1280, 3), None),
           'deblur_small': ((40, 720, 1280, 3), None),
           'denoise_plus': ((16, 480, 848, 3), 10.0 / 255.0),
           'denoise_small': ((16, 480, 848, 3), 10.0 / 255.0)}
TOP = 15


def stage_times(ev: Evaluator, forward) -> tuple[dict[str, float],
                                                dict[str, int]]:
    """Device ms per stage, from CUDA events recorded by forward hooks,
    and the peak allocated bytes of each stage (from the end of the stage
    before).  Repeated stages (orb1..orb5, the blocks of one Encoder2 level
    such as decoder_level1, decoder_level1_1, decoder_level1_2) are summed
    under one name, their peaks maximized."""
    marks: list[tuple[str, torch.cuda.Event, torch.cuda.Event, int]] = []
    open_ev: dict[str, torch.cuda.Event] = {}
    hooks = []
    model = ev.model
    mods = [(n, m) for n, m in model.named_children() if n != 'stage1']
    mods += [(f'stage1.{n}', m) for n, m in model.stage1.named_children()]
    for name, mod in mods:
        def pre(_m, _a, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            open_ev[name] = e

        def post(_m, _a, _o, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, open_ev.pop(name), e,
                          torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    try:
        torch.cuda.reset_peak_memory_stats()
        forward()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    ms: dict[str, float] = defaultdict(float)
    peak: dict[str, int] = defaultdict(int)
    for name, a, b, p in marks:
        key = re.sub(r'^(r?orb)\d+$', r'\1*', re.sub(r'_\d+$', '', name))
        ms[key] += a.elapsed_time(b)
        peak[key] = max(peak[key], p)
    return dict(ms), dict(peak)


def profile_config(variant: str, overrides: dict, state,
                   clip: np.ndarray, sigma: float | None,
                   result_path: str, grids: int | None = None) -> None:
    ev = Evaluator(variant, state, device='cuda', overrides=overrides,
                   result_path=result_path)
    print(f'== {variant} {configuration(ev.model.cfg)} {tuple(clip.shape)} '
          f'{ev.dtype}{f" grids {grids}" if grids else ""} ==', flush=True)

    def forward():
        if grids:
            return ev.forward_grids(clip, sigma, crop_size=grids)
        return ev.forward_window(clip, sigma)
    forward()
    torch.cuda.synchronize()

    stages, peaks = stage_times(ev, forward)
    total = sum(stages.values())
    print(f'stages (device ms, CUDA events; {total:.1f} ms in all; peak '
          f'{max(peaks.values()) / 1e9:.3f} GB):')
    for stage, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f'  {ms:10.1f} ms {100 * ms / total:5.1f} %  peak '
              f'{peaks[stage] / 1e9:7.3f} GB  {stage}')

    traced(forward)


def traced(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and print the wall time,
    the device-busy share of it (the union of kernel intervals), the port
    kernels' share of the kernel time, each port kernel's time and
    launches (every instantiation and form summed) and the top kernels;
    returns the wall and busy seconds and the kernel seconds by name."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device events but the ranges that annotate host code on the device's
    # timeline (``Optimizer.step#AdamW.step``), which hold no kernel
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)
               and not e.name.startswith('Command Buffer Full')]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float('-inf')
    for a, b in spans:  # union of kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    dev_us = sum(v[0] for v in by_name.values())
    by_port: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for kname, (us, n) in by_name.items():
        port = port_kernel(kname)
        if port:
            by_port[port][0] += us
            by_port[port][1] += n
    ours_us = sum(v[0] for v in by_port.values())
    print(f'wall {wall:.3f} s; device busy {busy_us / 1e6:.3f} s '
          f'({100 * busy_us / 1e6 / wall:.1f} % of wall, idle '
          f'{100 - 100 * busy_us / 1e6 / wall:.1f} %); kernel time '
          f'{dev_us / 1e6:.3f} s, port kernels {ours_us / 1e6:.3f} s '
          f'({100 * ours_us / max(dev_us, 1):.1f} %)')
    print('port kernels (all forms and instantiations):')
    for port, (us, n) in sorted(by_port.items(), key=lambda kv: -kv[1][0]):
        print(f'{us / 1e3:12.2f} ms {n:6d}x  {100 * us / max(dev_us, 1):5.1f} '
              f'%  {port}')
    print('top kernels:')
    for kname, (us, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:TOP]:
        print(f'{us / 1e3:12.2f} ms {n:6d}x  {kname[:100]}', flush=True)
    return {'wall_s': wall, 'busy_s': busy_us / 1e6, 'kernel_s': dev_us / 1e6,
            'port_s': ours_us / 1e6,
            'top': sorted(((us / 1e6, n, k) for k, (us, n) in by_name.items()),
                          reverse=True)[:TOP]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', choices=list(WINDOWS), default='deblur_plus')
    ap.add_argument('--config', nargs='+', choices=list(CONFIG_OVERRIDES),
                    default=['fused_chw'],
                    help='configurations to profile, in this order')
    ap.add_argument('--result_path', default='results',
                    help='directory of the evaluator log')
    ap.add_argument('--grids', type=int, default=None, metavar='CROP',
                    help='profile forward_grids in CROP-sized crops')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_forward: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    state = init_state(build_model(args.variant), seed=0)
    window, sigma = WINDOWS[args.variant]
    clip = np.random.default_rng(1).uniform(0, 1, window).astype(np.float32)
    for name in args.config:
        profile_config(args.variant, CONFIG_OVERRIDES[name], state, clip,
                       sigma, args.result_path, args.grids)
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
