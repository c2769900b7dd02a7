"""Probe: stride-2 lane access (the strided-copy kernel's three modes), and
the plain CAB against the port's CAB kernels.

  python -m shiftnet_tpu_torch.tools.probe_chw [stride|bench]

The port's counterpart of the JAX package's ``tools/probe_chw.py``.

``stride`` (the default): ``ops.probes.strided_copy`` on x (24, 2560) bf16,
x = arange, in the three modes of the JAX tool's Pallas probes: a lane
stride of 2 (``k_lane_stride``), every other block of 128 lanes
(``k_sub_stride``) and a stride-2 store into zeros (``k_store``); each
checked against its plain version and timed; then the JAX tool's flat
deinterleave of a (16, 24, 384*1280) tensor, ``v[..., ::2] * 1.5`` in
plain PyTorch, beside the lane-stride kernel on the same tensor.

``bench``: the JAX tool's ``cpu`` and ``tpu`` modes in one: a seeded plain
CAB (cuDNN convs and PyTorch) against the same CAB on the port's
``cab_front`` + ``cab_back`` kernels, at (8, 24, 384, 1280) bf16: ms per
CAB, ms per frame, and the normalized max error.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys

import torch

from shiftnet_tpu_torch.ops import probes
from shiftnet_tpu_torch.tools.timing import (bytes_ms, card, median_ms,
                                             randn_bf16, require_cuda)

C, M = 24, 2560
FLAT = (16, 24, 384 * 1280)


def _arange() -> torch.Tensor:
    return torch.arange(C * M, dtype=torch.float32, device='cuda').reshape(
        C, M).to(torch.bfloat16)


def _report(label: str, x: torch.Tensor, mode: str) -> bool:
    out = probes.strided_copy(x, mode)
    ok = torch.equal(out, probes.strided_copy_plain(x, mode))
    ms = median_ms(lambda: probes.strided_copy(x, mode))
    read = x.numel() // 2 if mode == 'block' else x.numel()
    bound = bytes_ms(2 * (read + out.numel()))
    print(f'{label}: {"OK" if ok else "FAIL"} correct={ok}  '
          f'{1e3 * ms:.2f} us (bound {1e3 * bound:.3f} us)', flush=True)
    return ok


def lane_stride() -> bool:
    """out = x[:, ::2]."""
    return _report('lane-strided slice', _arange(), 'lane')


def sub_stride() -> bool:
    """out = x.reshape(c, m / 128, 128)[:, ::2].reshape(c, m / 2)."""
    return _report('row-block-strided slice', _arange(), 'block')


def strided_store() -> bool:
    """out = 0; out[:, ::2] = x[:, :m / 2]."""
    return _report('lane-strided store', _arange()[:, :M // 2].contiguous(),
                   'store')


def probe_stride() -> bool:
    ok = lane_stride() & sub_stride() & strided_store()
    big = randn_bf16(FLAT, 0)
    ms = median_ms(lambda: big[..., ::2] * 1.5)
    gb = big.numel() * 2 * 1.5 / 1e9
    print(f'torch flat deinterleave {FLAT}: {ms:.3f} ms '
          f'({gb / ms * 1e3:.0f} GB/s dense)', flush=True)
    flat = big.view(-1, FLAT[2])
    ms = median_ms(lambda: probes.strided_copy(flat, 'lane'))
    print(f'strided_copy lane {tuple(flat.shape)}: {ms:.3f} ms '
          f'({gb / ms * 1e3:.0f} GB/s dense, bound '
          f'{bytes_ms(gb * 1e9):.3f} ms)', flush=True)
    return ok


def bench_cab() -> None:
    from shiftnet_tpu_torch.models import init_state, layers

    t, c, h, w = 8, 24, 384, 1280
    plain = layers.CAB(c, kernel_size=3, reduction=4)
    plain.load_state_dict(init_state(plain, seed=1))
    fused = layers.CAB(c, kernel_size=3, reduction=4, fused=True)
    fused.load_state_dict(plain.state_dict())
    # float32 parameters, bf16 activations: the Evaluator's bf16 setting
    plain, fused = (m.to('cuda').eval() for m in (plain, fused))
    x = randn_bf16((t, c, h, w), 0)
    with torch.inference_mode():
        for name, mod in (('plain CAB (cuDNN + PyTorch)', plain),
                          ('cab_front + cab_back kernels', fused)):
            ms = median_ms(lambda: mod(x))
            print(f'{name} ({t},{c},{h},{w}) {ms:8.3f} ms per CAB, '
                  f'{ms / t:.3f} ms/frame', flush=True)
        ref, got = plain(x).double(), fused(x).double()
    err = float((got - ref).abs().max() / ref.std())
    print(f'kernels vs plain: normalized max error {err:.3e}')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('mode', nargs='?', default='stride',
                    choices=['stride', 'bench'])
    mode = ap.parse_args(argv).mode
    require_cuda('probe_chw')
    print(card())
    if mode == 'bench':
        bench_cab()
        return 0
    return 0 if probe_stride() else 1


if __name__ == '__main__':
    sys.exit(main())
