"""Training CLI of the port (counterpart of ``shiftnet_tpu/tools/train.py``).

Usage:
  python -m shiftnet_tpu_torch.tools.train -opt configs/gopro_deblur.yml \\
      [--device cuda] [--backend {nccl,gloo}]
  torchrun --standalone --nproc_per_node N \\
      -m shiftnet_tpu_torch.tools.train -opt configs/gopro_deblur_dp8.yml

Reads the JAX package's YAML configs unchanged (``configs/*.yml``) and trains
on the GPU (``--device cpu`` runs on the plain versions, at toy sizes).
Under torchrun the N ranks train one model: data parallel, or sequence
parallel over rings of the config's ``time_parallel`` ranks
(``train/trainer.py``), each rank on ``cuda:{LOCAL_RANK}``, over NCCL when
every rank has a GPU of its own and gloo when ranks share one
(``parallel/mesh.py``; ``--backend`` forces either).  Re-running the same
config resumes from its latest checkpoint.
"""
import argparse

from shiftnet_tpu_torch.parallel.mesh import init_distributed
from shiftnet_tpu_torch.train.trainer import Trainer
from shiftnet_tpu_torch.utils.config import load_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('-opt', required=True, help='path to yaml config')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--backend', choices=['nccl', 'gloo'], default=None,
                    help='force the process group backend under torchrun')
    args = ap.parse_args(argv)
    opt = load_config(args.opt, is_train=True)
    opt['device'] = str(init_distributed(args.device, backend=args.backend))
    trainer = Trainer(opt)
    trainer.run()
    return trainer


if __name__ == '__main__':
    main()
