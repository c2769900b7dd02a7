"""The precisions the reference computes in: float32 with TF32 off (the
reference itself), and the controls one step below a configuration's own
precision (TF32 for float32; fp8 for bfloat16)."""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0      # float8_e4m3fn, activations and weights
E5M2_MAX = 57344.0    # float8_e5m2, gradients


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x through ``dtype`` with a per-tensor scale that puts its largest
    magnitude at the format's largest value."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = top / amax
    return ((x.float() * s).to(dtype).float() / s).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 training's rounding: e4m3 forward, e5m2 for the gradient."""
    return _Fp8.apply(x)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 convs and matmuls with TF32 on or off (off: the reference),
    cuDNN choosing its fastest algorithm for each shape (the reference runs
    after the program's window, so this changes nothing the window
    measures)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    b.cudnn.benchmark = True
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.benchmark) = saved


# A configuration's precision -> (the conv rounding, TF32) of its control.
CONTROLS = {'bfloat16': (fp8, False), 'float32': (None, True)}
