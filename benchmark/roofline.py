"""The yardstick of the kernels: the card's peaks, and each port kernel's
operations and bytes as functions of the shapes of its call.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit):

- bfloat16: 989 TFLOP/s on the tensor cores;
- float32: 495 TFLOP/s, the TF32 tensor-core rate.  The port computes
  float32 on the tensor cores as 3xTF32 (three TF32 products a
  multiply-add), so it can pass the 67 TFLOP/s of the float32 units; the
  TF32 rate is the highest at which this card multiplies float32
  operands, so no float32 kernel can read over it;
- device memory: 3.35 TB/s.

Operations count the mathematical op's multiply-adds x 2 (the counts of
the kernel cases of ``chip_smoke.py``, generalised to any shape); bytes
count each input byte read once and each output byte written once (the
packed weight panels at their size, in the compute type).  A call's bound
is the larger of ops / peak and bytes / bandwidth.
"""
from __future__ import annotations

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _px(x) -> int:
    """Frames x pixels of a (T, C, H, W) tensor."""
    return x.shape[0] * x.shape[2] * x.shape[3]


def conv_out(h: int, w: int, k: int, stride: int) -> tuple[int, int]:
    pad = k // 2 if stride == 1 else (1 if k == 3 else 0)
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def cab_front(x, w1, alpha, w2, **_):
    """conv3x3 -> PReLU -> conv3x3, C -> C, and the channel sums."""
    t, c = x.shape[:2]
    ops = 2 * 2 * 9 * c * c * _px(x)
    out = nbytes(x) + t * c * 4
    return ops, nbytes(x) + 2 * 9 * c * c * x.element_size() + 4 + out


def cab_back(x, s, ca, **_):
    """x + s * ca[t, c]."""
    return 2 * x.numel(), 3 * nbytes(x) + nbytes(ca)


def conv(x, w, bias, alpha, stride=1, **_):
    t, cin, h, wd = x.shape
    cout, _, k, _ = w.shape
    ho, wo = conv_out(h, wd, k, stride)
    n_out = t * ho * wo
    return (2 * k * k * cin * cout * n_out,
            nbytes(x) + w.numel() * x.element_size() + nbytes(bias, alpha)
            + n_out * cout * x.element_size())


def conv_concat(xs, w, bias, alpha, **_):
    x = xs[0]
    cout = w.shape[0]
    cin = sum(v.shape[1] for v in xs)
    return (2 * 9 * cin * cout * _px(x),
            nbytes(*xs) + w.numel() * x.element_size() + nbytes(bias, alpha)
            + _px(x) * cout * x.element_size())


def up_skip(x, w11, skip, **_):
    """conv1x1 at the low resolution, bilinear 2x, + skip."""
    cin, cout = x.shape[1], w11.shape[0]
    return (2 * cin * cout * _px(x),
            nbytes(x) + w11.numel() * x.element_size() + 2 * nbytes(skip))


def shift_round(x, number, **_):
    """A copy: y, and hw of the 8 * number moved channels."""
    hw = x.shape[0] * 8 * number * x.shape[2] * x.shape[3]
    return 0, 2 * nbytes(x) + hw * x.element_size()


def naf_gate(y, hw, prep, **_):
    """[dw3x3(hw)] -> LayerNorm folded into the 1x1 expand n+add_c -> 2n ->
    dw3x3 + identity -> SimpleGate, and the channel sums."""
    t, n = y.shape[:2]
    add_c = 0 if hw is None else hw.shape[1]
    cin = n + add_c
    px = _px(y)
    ops = 2 * px * (2 * n * cin + 9 * add_c + 9 * 2 * n) + px * n
    weights = nbytes(*(prep[k] for k in ('wg_p', 'c1', 'c2', 'dw0', 'dwc')))
    return ops, 2 * nbytes(y) + nbytes(hw) + weights + t * n * 4


def naf_rep(g, cag, prep, **_):
    """[g * cag] -> merged 5x5 RepConv (grouped or depthwise) -> 1x1
    expand n -> 2n -> SimpleGate2, and the channel sums."""
    t, n = g.shape[:2]
    cin_g = prep['rep'].shape[1]
    rep = prep['rep_p'] if cin_g == 8 else prep['rep']
    ops = 2 * _px(g) * (25 * cin_g * n + 2 * n * n)
    return ops, (2 * nbytes(g) + nbytes(cag, rep, prep['w4_p'])
                 + t * n * 4)


def naf_back(y, s, ca, prep, **_):
    """y + beta * (w7 . (s * ca) + b7)."""
    n = y.shape[1]
    return (2 * _px(y) * n * n,
            3 * nbytes(y) + nbytes(ca, prep['w7_p'], prep['beta'],
                                   prep['b7']))


# The port kernels by their names in the trace: the module of
# ``shiftnet_tpu_torch.ops`` that holds the entry point, its name, and the
# count of its ops and bytes.
KERNELS = {
    'cab_front': ('chw', 'cab_front', cab_front),
    'cab_back': ('chw', 'cab_back', cab_back),
    'conv': ('chw', 'conv', conv),
    'conv_cat': ('chw', 'conv_concat', conv_concat),
    'up_skip': ('chw', 'up_skip', up_skip),
    'shift_round': ('naf_chw', 'shift_round', shift_round),
    'naf_gate': ('naf_chw', 'naf_gate', naf_gate),
    'naf_rep': ('naf_chw', 'naf_rep', naf_rep),
    'naf_back': ('naf_chw', 'naf_back', naf_back),
}


def bound_s(ops: float, nbytes_: float, dtype: torch.dtype) -> float:
    """The least time the card could take for a call."""
    return max(ops / PEAK_FLOPS[dtype], nbytes_ / HBM_BYTES_PER_S)
