"""Denoise evaluation CLI of the port (counterpart of
``shiftnet_tpu/tools/test_denoise.py``).

Usage:
  python -m shiftnet_tpu_torch.tools.test_denoise \\
      --variant {denoise_plus,denoise_small} --model_path ckpt.npz \\
      --data_path DAVIS-test --sigma 10 [--quadrant] [--fp32 | --bf16] \\
      [--save_image] [--device cuda] [--metric niqe=calculate_niqe ...] \\
      [--grids [--crop_size 256] [--trans_num 8]] [--profile DIR]

``--data_path`` holds one folder of clean frames per video; the noise of
``--sigma`` (0-255 scale) is drawn from ``--seed``.  ``--model_path`` takes
the torch-keyed ``.npz`` exports of either package or a reference ``.pth``
checkpoint.  Denoise evaluates in float32 unless ``--bf16``.  ``--metric``,
``--grids`` and ``--profile`` as in ``test_deblur``; ``--no_tile`` is the
JAX CLI's deprecated alias of the default (the full window) and does
nothing.  ``--tp N`` splits each window's frames over N ranks, as in
``test_deblur`` (not with ``--quadrant`` or ``--grids``, which raise).
"""
import argparse
import os

from shiftnet_tpu_torch.eval.runner import Evaluator
from shiftnet_tpu_torch.parallel.mesh import init_distributed
from shiftnet_tpu_torch.tools.params_io import load_state
from shiftnet_tpu_torch.utils.profiling import trace


def add_validation_args(ap: argparse.ArgumentParser):
    """The flags both CLIs share with the JAX CLIs
    (``shiftnet_tpu/tools/test_denoise.py:38-49``)."""
    ap.add_argument('--metric', action='append', default=None,
                    help='metric registry entries, e.g. '
                         '--metric niqe=calculate_niqe (repeatable); '
                         'default psnr+ssim')
    ap.add_argument('--profile', default=None,
                    help='write a torch.profiler Chrome trace into this dir')
    ap.add_argument('--grids', action='store_true',
                    help='validation-style overlap-averaged crop tiling '
                         '(reference image_restoration_model.py:161-252)')
    ap.add_argument('--crop_size', type=int, default=256)
    ap.add_argument('--trans_num', type=int, default=1,
                    help='number of rot/flip TTA transforms per crop (1-8)')
    ap.add_argument('--tp', type=int, default=1,
                    help='split each window over N ranks (sequence-parallel '
                         'inference; run under torchrun --nproc_per_node N)')


def tp_device(tp: int, device: str):
    """Join the process group of a ``--tp`` run and return the rank's
    device; raises unless the launcher started exactly ``tp`` ranks
    (``WORLD_SIZE``)."""
    world = int(os.environ.get('WORLD_SIZE', 1))
    if tp != world:
        raise SystemExit(f'--tp {tp} with WORLD_SIZE {world}: launch with '
                         f'torchrun --nproc_per_node {tp}')
    return init_distributed(device) if tp > 1 else device


def parse_metric_args(entries):
    """['niqe=calculate_niqe', 'psnr'] -> the registry's metric dict, None
    without entries (``shiftnet_tpu/tools/test_denoise.py:67-77``)."""
    if not entries:
        return None
    out = {}
    for e in entries:
        name, _, typ = e.partition('=')
        out[name] = {'type': typ or name}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', default='denoise_plus',
                    choices=['denoise_plus', 'denoise_small'])
    ap.add_argument('--model_path', required=True)
    ap.add_argument('--data_path', required=True)
    ap.add_argument('--result_path', default='infer_results')
    ap.add_argument('--sigma', type=float, default=10.0)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--quadrant', action='store_true',
                    help="the reference's four quadrant tiles "
                         '(test_denoise.py:153-173) for every window')
    prec = ap.add_mutually_exclusive_group()
    prec.add_argument('--fp32', action='store_true',
                      help='float32 (the denoise default)')
    prec.add_argument('--bf16', action='store_true')
    ap.add_argument('--no_tile', action='store_true',
                    help='deprecated alias: the full window is the default')
    ap.add_argument('--save_image', action='store_true')
    ap.add_argument('--device', default='cuda')
    add_validation_args(ap)
    args = ap.parse_args(argv)

    device = tp_device(args.tp, args.device)
    state = load_state(args.variant, args.model_path)
    ev = Evaluator(args.variant, state, device=device,
                   result_path=args.result_path,
                   bf16=True if args.bf16 else None,
                   save_images=args.save_image,
                   metrics=parse_metric_args(args.metric), tp=args.tp)
    with trace(args.profile):
        res = ev.eval_denoise(args.data_path, args.sigma, tile=args.quadrant,
                              seed=args.seed, grids=args.grids,
                              crop_size=args.crop_size,
                              trans_num=args.trans_num)
    if ev.primary:
        print(res)
    return res


if __name__ == '__main__':
    main()
