"""Denoise evaluation CLI of the port (counterpart of
``shiftnet_tpu/tools/test_denoise.py``).

Usage:
  python -m shiftnet_tpu_torch.tools.test_denoise \\
      --variant {denoise_plus,denoise_small} --model_path ckpt.npz \\
      --data_path DAVIS-test --sigma 10 [--quadrant] [--fp32 | --bf16] \\
      [--save_image] [--device cuda]

``--data_path`` holds one folder of clean frames per video; the noise of
``--sigma`` (0-255 scale) is drawn from ``--seed``.  ``--model_path`` takes
the torch-keyed ``.npz`` exports of either package or a reference ``.pth``
checkpoint.  Denoise evaluates in float32 unless ``--bf16``.
"""
import argparse

from shiftnet_tpu_torch.eval.runner import Evaluator
from shiftnet_tpu_torch.tools.params_io import load_state


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
    ap.add_argument('--save_image', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    state = load_state(args.variant, args.model_path)
    ev = Evaluator(args.variant, state, device=args.device,
                   result_path=args.result_path,
                   bf16=True if args.bf16 else None,
                   save_images=args.save_image)
    print(ev.eval_denoise(args.data_path, args.sigma, tile=args.quadrant,
                          seed=args.seed))


if __name__ == '__main__':
    main()
