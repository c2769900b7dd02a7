"""Deblur evaluation CLI of the port (counterpart of
``shiftnet_tpu/tools/test_deblur.py``).

Usage:
  python -m shiftnet_tpu_torch.tools.test_deblur \\
      --variant {deblur_plus,deblur_small} --model_path ckpt.npz \\
      --data_path DeepVideoDeblurring_Dataset/GoPro --one_len 48 \\
      [--fp32] [--save_image] [--device cuda] \\
      [--metric niqe=calculate_niqe ...] [--grids [--crop_size 256] \\
      [--trans_num 8]] [--profile DIR]
  torchrun --standalone --nproc_per_node N \\
      -m shiftnet_tpu_torch.tools.test_deblur --tp N ...

``--model_path`` takes the torch-keyed ``.npz`` exports of either package or
a reference ``.pth`` checkpoint.  ``--metric`` picks metrics of
``eval/registry.py`` by name (default PSNR and SSIM); ``--grids`` runs the
reference's validation tiling with ``--trans_num`` rot/flip transforms per
crop; ``--profile`` writes a ``torch.profiler`` Chrome trace into DIR.
``--tp N`` (sequence-parallel inference, under torchrun with N ranks)
splits each window's frames over the ranks, each on its own card (NCCL)
or sharing one (gloo, ``parallel/mesh.py``); every rank reads the window,
rank 0 alone scores it, logs and writes the images.  It raises with
``--grids``, and when N is not ``WORLD_SIZE``.
"""
import argparse

from shiftnet_tpu_torch.eval.runner import Evaluator
from shiftnet_tpu_torch.tools.params_io import load_state
from shiftnet_tpu_torch.tools.test_denoise import (add_validation_args,
                                                   parse_metric_args,
                                                   tp_device)
from shiftnet_tpu_torch.utils.profiling import trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', default='deblur_plus',
                    choices=['deblur_plus', 'deblur_small'])
    ap.add_argument('--model_path', required=True)
    ap.add_argument('--data_path', required=True)
    ap.add_argument('--result_path', default='infer_results')
    ap.add_argument('--one_len', type=int, default=48)
    ap.add_argument('--fp32', action='store_true')
    ap.add_argument('--save_image', action='store_true')
    ap.add_argument('--device', default='cuda')
    add_validation_args(ap)
    args = ap.parse_args(argv)

    device = tp_device(args.tp, args.device)
    state = load_state(args.variant, args.model_path)
    ev = Evaluator(args.variant, state, device=device,
                   result_path=args.result_path,
                   bf16=False if args.fp32 else None,
                   save_images=args.save_image,
                   metrics=parse_metric_args(args.metric), tp=args.tp)
    with trace(args.profile):
        res = ev.eval_deblur(args.data_path, one_len=args.one_len,
                             grids=args.grids, crop_size=args.crop_size,
                             trans_num=args.trans_num)
    if ev.primary:
        print(res)
    return res


if __name__ == '__main__':
    main()
