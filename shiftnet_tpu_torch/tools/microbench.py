"""Kernel-design micro-benchmarks on the card: conv-as-matmul formulations
at the TFR U-Net width, the staged copy of a narrow channel-minor tensor,
and elementwise bandwidth.

  python -m shiftnet_tpu_torch.tools.microbench

The port's counterpart of the JAX package's ``tools/microbench.py``, at its
shape, (16, 384, 1280, 24) bf16 NHWC: a 3x3 conv 24 -> 24 as ``F.conv2d``
in ``channels_last`` (cuDNN), as 9 tap matmuls, as im2col, as a 2x2
space-to-depth product, and a dense (M/4, 512) @ (512, 512) product; then
``out[0] = 2 * x[0]`` through ``ops.probes.block_copy_staged`` in 32-row
slabs (the Pallas ``copy_kernel``; its route printed, the TMA at this
shape), checked bit for bit against its plain version; then ``x * 1.5 +
0.25`` at 24 and 128 channels.  The formulations are plain PyTorch
measurements, not kernels of the port.  Median of 20 CUDA-event-timed
runs per op.  Needs a CUDA device.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from shiftnet_tpu_torch.ops import probes
from shiftnet_tpu_torch.tools.timing import (bytes_ms, card, median_ms,
                                             rand_bf16, require_cuda)

T, H, W, C = 16, 384, 1280, 24
SLAB = 32


def timeit(name: str, fn) -> float:
    ms = median_ms(fn)
    print(f'{name:<46s} {ms:8.3f} ms', flush=True)
    return ms


def conv_formulations(x: torch.Tensor) -> None:
    """x: (T, H, W, C) NHWC."""
    t, h, w, c = x.shape
    m = t * h * w
    flops = 2 * 9 * c * c * m
    print(f'== conv3x3 formulations at ({t},{h},{w},{c}) bf16, per-op ms ==')
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wk = rand_bf16((c, c, 3, 3), 1).contiguous(
        memory_format=torch.channels_last)
    d = timeit('F.conv2d channels_last (cuDNN)',
               lambda: F.conv2d(xc, wk, padding=1))
    print(f'    -> {flops / d / 1e9:.1f} TFLOP/s effective')

    wt = rand_bf16((9, c, c), 2)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))

    def taps():
        acc = None
        for i in range(9):
            dy, dx = divmod(i, 3)
            r = torch.matmul(xp[:, dy:dy + h, dx:dx + w].reshape(m, c),
                             wt[i]).float()
            acc = r if acc is None else acc + r
        return acc.to(torch.bfloat16).reshape(t, h, w, c)
    d = timeit('tap matmuls (M,24)@(24,24) x9', taps)
    print(f'    -> {flops / d / 1e9:.1f} TFLOP/s effective')

    wi = rand_bf16((9 * c, c), 3)

    def im2col():
        cols = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                for dx in range(3)]
        p = torch.cat(cols, dim=-1).reshape(m, 9 * c)
        return torch.matmul(p, wi).reshape(t, h, w, c)
    d = timeit('im2col (M,216)@(216,24)', im2col)
    print(f'    -> {flops / d / 1e9:.1f} TFLOP/s effective')

    ws = rand_bf16((16 * c, 4 * c), 4)
    xs = x.reshape(t, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(t, h // 2, w // 2, 4 * c)
    xsp = F.pad(xs, (0, 0, 1, 1, 1, 1))

    def s2d():
        cols = [xsp[:, dy:dy + h // 2, dx:dx + w // 2] for dy in range(2)
                for dx in range(2)]
        p = torch.cat(cols, dim=-1).reshape(m // 4, 16 * c)
        return torch.matmul(p, ws).reshape(t, h // 2, w // 2, 4 * c)
    d = timeit('s2d2x2 (M/4,384)@(384,96)', s2d)
    print(f'    -> real {flops / d / 1e9:.1f} TFLOP/s '
          f'(tensor cores {2 * 16 * c * 4 * c * m / 4 / d / 1e9:.1f})')

    a = rand_bf16((m // 4, 512), 5)
    b = rand_bf16((512, 512), 6)
    d = timeit('dense (M/4,512)@(512,512)', lambda: torch.matmul(a, b))
    print(f'    -> {2 * 512 * 512 * m / 4 / d / 1e9:.1f} TFLOP/s')


def copy_x2(x: torch.Tensor) -> dict:
    """The Pallas ``copy_kernel``: out[0] = 2 * x[0] through shared memory
    in slabs of 32 rows.  x: (T, H, W, C); returns the case's record."""
    t, h, w, c = x.shape
    src = x.view(t, h, w * c)
    pieces = probes.slab_pieces(h, SLAB)

    def run():
        return probes.block_copy_staged(src, (1, h, w * c), pieces, w * c,
                                        scale=2.0)
    got = run()
    route = probes.staged_route(src, (1, h, w * c))
    want = probes.block_copy_plain(src, (1, h, w * c), pieces, w * c,
                                   scale=2.0)
    ok = torch.equal(probes.written(got, pieces, w * c),
                     probes.written(want, pieces, w * c))
    ms = median_ms(run)
    nbytes = h * w * c * 2 * 2
    print(f'{"staged copy x2 (32 rows,1280,24) unpadded":<46s} {ms:8.3f} ms'
          f'  -> {nbytes / ms / 1e6:.0f} GB/s (bound {bytes_ms(nbytes):.3f} '
          f'ms)  route {route}  {"OK bit-exact" if ok else "FAIL"}',
          flush=True)
    return dict(ms=ms, ok=ok)


def main() -> int:
    require_cuda('microbench')
    print(card())
    x = rand_bf16((T, H, W, C), 0)
    conv_formulations(x)
    print('== staged copy: unpadded channel minor ==')
    ok = copy_x2(x)['ok']
    print('== elementwise bandwidth reference ==')
    d = timeit('elementwise (t,h,w,24)', lambda: x * 1.5 + 0.25)
    print(f'    -> {x.numel() * 2 * 2 / d / 1e6:.0f} GB/s (dense bytes)')
    x128 = F.pad(x, (0, 128 - C))
    d = timeit('elementwise (t,h,w,128)', lambda: x128 * 1.5 + 0.25)
    print(f'    -> {x128.numel() * 2 * 2 / d / 1e6:.0f} GB/s')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
