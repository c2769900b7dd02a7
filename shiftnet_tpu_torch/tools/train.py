"""Training CLI of the port (counterpart of ``shiftnet_tpu/tools/train.py``).

Usage:
  python -m shiftnet_tpu_torch.tools.train -opt configs/gopro_deblur.yml \\
      [--device cuda]

Reads the JAX package's YAML configs unchanged (``configs/*.yml``) and trains
on the GPU (``--device cpu`` runs on the plain versions, at toy sizes).
Re-running the same config resumes from its latest checkpoint.
"""
import argparse

from shiftnet_tpu_torch.train.trainer import Trainer
from shiftnet_tpu_torch.utils.config import load_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('-opt', required=True, help='path to yaml config')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    opt = load_config(args.opt, is_train=True)
    opt['device'] = args.device
    trainer = Trainer(opt)
    trainer.run()
    return trainer


if __name__ == '__main__':
    main()
