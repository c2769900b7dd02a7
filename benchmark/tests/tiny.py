"""A tiny benchmark root for the CPU tests: narrowed models (TINY) at
small frames, in float32, with the repository's readers, so that a whole
run (set-up, window, trace, check) takes seconds on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import manifest

TINY = dict(n_feats0=8, n_feats2=48, num_orbs=1, tfr_scale=4, shift_rounds=2)
# float32 on both sides: gaps of float32 rounding
LIMITS = {'restore': {'rms_err': 1e-5, 'max_err': 1e-4},
          'train': {'grad_gap': 1e-3, 'change_gap': 1e-2}}
CELLS = {
    'tiny.window': ('deblur_plus', 'window', {
        'kind': 'restore', 'frames': 8, 'halo': 2, 'height': 32,
        'width': 48, 'mod_crop': 4, 'pool': 2, 'sigmas_255': None,
        'configuration': 'fused_chw', 'trace_units': 2,
        'reference_block': 3}),
    'tiny_dn.quadrant': ('denoise_plus', 'quadrant', {
        'kind': 'restore', 'frames': 6, 'halo': 2, 'height': 64,
        'width': 102, 'mod_crop': 4, 'pool': 2, 'sigmas_255': [10, 50],
        'configuration': 'fused_chw', 'trace_units': 2,
        'reference_block': 4}),
    'tiny.step': ('deblur_plus', 'step', {
        'kind': 'train', 'frames': 5, 'patch': 32, 'batch': 1,
        'loss': '1*L1', 'fused': False, 'optim': {
            'lr': 4e-4, 'betas': [0.9, 0.99], 'weight_decay': 0.0,
            'total_iters': 1000, 'eta_min': 1e-7, 'scheduler_kind': 'cosine',
            'scheduler_kwargs': {'T_max': 1000}, 'grad_clip': 0.01},
        'check_steps': 3, 'trace_units': 2}),
}


def make_root(tmp: Path) -> Path:
    """BENCHMARK.json and the data files of the tiny cells under ``tmp``,
    with the repository's per-layer metrics and readers."""
    real = manifest.load()
    b = tmp / 'benchmark'
    for d in ('configs', 'traffic', 'limits'):
        (b / d).mkdir(parents=True)
    shutil.copytree(manifest.ROOT / 'benchmark' / 'layer_metrics',
                    b / 'layer_metrics')
    configs = {}
    for name, (variant, traffic, tr) in CELLS.items():
        cname = name.split('.')[0]
        src = json.loads((manifest.ROOT / 'benchmark' / 'configs'
                          / f'{variant}.json').read_text())
        src['model'].update(TINY)
        src['precision'] = {'restore': 'float32', 'train': 'float32'}
        (b / 'configs' / f'{cname}.json').write_text(json.dumps(src))
        configs[cname] = {'name': cname, 'source': src['source'],
                          'file': f'benchmark/configs/{cname}.json',
                          'reduced': sorted(TINY), 'why': 'CPU test'}
        (b / 'traffic' / f'{traffic}.json').write_text(json.dumps(tr))
        (b / 'limits' / f'{name}.json').write_text(
            json.dumps({'limits': LIMITS[tr['kind']]}))
    kinds = {n: t['kind'] for n, (_, _, t) in CELLS.items()}
    man = dict(real, configs=list(configs.values()), workloads=[
        {'name': n, 'config': n.split('.')[0], 'traffic': t, 'chips': 1,
         'why': 'CPU test'} for n, (_, t, _) in CELLS.items()])
    for m in man['end_to_end'] + man['per_layer']:
        if 'workloads' in m:
            kind = ('train' if any('train' in w for w in m['workloads'])
                    else 'restore')
            m['workloads'] = [n for n, k in kinds.items() if k == kind]
    (tmp / 'BENCHMARK.json').write_text(json.dumps(man))
    return tmp
