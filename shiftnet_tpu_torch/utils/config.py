"""YAML experiment configuration.

The port's own copy of ``shiftnet_tpu/utils/config.py``.  Mirrors the
reference's key surface (``options/*.yml`` + ``basicsr/utils/options.py``):
flat top-level dataset/model keys plus ``train``/``val``/``logger``
sections, experiment path derivation (``options.py:73-82``) and debug-mode
frequency shrinking (``options.py:84-89``).
"""
from __future__ import annotations

import os
from typing import Any

import yaml


def load_config(path: str, is_train: bool = True) -> dict[str, Any]:
    with open(path) as f:
        opt = yaml.safe_load(f)
    opt['is_train'] = is_train
    name = opt.get('name', os.path.splitext(os.path.basename(path))[0])
    opt['name'] = name

    root = opt.get('experiments_root', 'experiments')
    exp = os.path.join(root, name)
    opt.setdefault('path', {})
    opt['path'].update({
        'experiments_root': exp,
        'models': os.path.join(exp, 'models'),
        'training_states': os.path.join(exp, 'training_states'),
        'log': exp,
        'visualization': os.path.join(exp, 'visualization'),
    })

    if 'debug' in name:  # debug convention: tiny frequencies
        opt.setdefault('logger', {})
        opt['logger']['print_freq'] = 1
        opt['logger']['save_checkpoint_freq'] = 8
        if 'val' in opt:
            opt['val']['val_freq'] = 8
    return opt


def make_exp_dirs(opt: dict[str, Any]) -> None:
    for key in ('experiments_root', 'models', 'training_states',
                'visualization'):
        os.makedirs(opt['path'][key], exist_ok=True)
