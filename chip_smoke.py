#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shiftnet_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which must pass:

1. device: the card's name and power limit, torch and CUDA versions.  There
   is no CPU path: without a CUDA device the run fails.
2. build: compile the CUDA kernels from ``shiftnet_tpu_torch/csrc`` (the
   nine model kernels, the four probe kernels and the parameter probe)
   into one library (one
   nvcc per source, in parallel), then count instructions in its SASS
   (``cuobjdump -sass``): every instantiation of the ``cab_front``,
   ``conv``, ``conv_cat``, ``naf_gate``, ``naf_rep``, ``naf_back`` and
   ``up_skip`` kernels must hold tensor-core (``HMMA``) instructions,
   cab_back's and the direct copy's 16-byte routes 128-bit global loads
   (``LDG.E.128``), the staged copy's TMA kernel TMA loads and stores
   (``UTMALDG``, ``UTMASTG``), and every ``mm_loop`` instantiation
   warpgroup products and TMA loads (``HGMMA``, ``UTMALDG``) and no
   ``mma.sync`` (``HMMA``); ``ptxas -v`` must report no spill and no
   serialized wgmma in ``mm_loop`` and the direct copy.
3. kernels: each kernel against its plain PyTorch version on seeded inputs
   at the shapes of the 720p deblur_plus window (T = 4), for conv_cat also
   the 480x848 denoise window, and at the small variants' widths (the
   depthwise naf_rep at n = 64 on its own row), in float32 (TF32 off) and
   bfloat16 (cab_back bit for bit, also in place, on its 16-byte route),
   with median times over 20 runs, the achieved rate of the kernels that
   compute (TF/s: their operations over their time), the least time the
   card could take for the same work (``bound_ms``) and, where one PyTorch
   call computes the same function, that call's time (``library_ms``).
4. deblur: the port's default ``Evaluator('deblur_plus')`` (bf16,
   ``fused_chw``: the main path) on a seeded 40x720x1280 window through
   ``forward_window``, with every kernel's launches counted against the
   counts the path implies and the peak device memory held against the
   window plan's estimate; the same for the ``conv_concat`` configuration
   (conv_cat at rconcat and conv_hr0) and the ``fused_tfr`` configuration
   (the TFR U-Nets' kernels only); then the whole model in each
   configuration against the all-plain model on a 5x720x1280 window.
5. denoise: the port's default ``Evaluator('denoise_plus')`` (float32,
   ``fused_chw``) at sigma 10/255 on the bench_denoise window (16x480x848)
   and a DAVIS-length one (54x480x848), each also with ``conv_concat``,
   with launches, times and peaks as above; a DAVIS-width 16x480x852 window,
   which must take the quadrant plan; the bf16 window's drift from the
   float32 one (information, not a check); the whole model against the
   all-plain model on a 5x480x848 window, with conv_concat off and on.
6. small: the default ``Evaluator('deblur_small')`` (bf16) on a seeded
   40x720x1280 window and ``Evaluator('denoise_small')`` (float32) at sigma
   10/255 on a 16x480x848 one, each on the full-window plan with its launch
   counts, peak and fps, and once with ``conv_concat``; a DAVIS-width
   16x480x852 denoise_small window, which must take the quadrant plan; the
   whole model of each against the all-plain model on a 5-frame window.
7. probes: the six probe tools of ``shiftnet_tpu_torch/tools`` (the port's
   counterparts of the JAX package's ``tools/`` probes), each driven
   through its entry point with the probe kernels' launches counted
   against what the tool implies and every tool's own checks passing;
   then each of the ten probe kernels of ``ops/probes.py`` against its
   plain version at the JAX tool's largest shape (the permutation also at
   the port's shift_round and decoder_level1 shapes), copies bit for bit
   (every staged copy on the TMA route, every direct copy in 16-byte
   units but the one at a lane offset) and ``mm_loop`` within one bf16
   ulp of its largest output (its route: the wgmma tile of ``MM_TILES``),
   with median times, bounds and the PyTorch call that computes the same
   function.
8. validation: the reference's validation protocol on the kernels
   (``Evaluator.forward_grids``, crops with rot/flip TTA): at a
   frame-covering crop it must equal ``forward_window``; on a 5x256x384
   window in crops of 128 with 8 transforms (48 forwards) the float32
   model on the kernels is held against the all-plain model; a deblur_plus
   40x720x1280 bf16 window in 15 crops of 256 is timed beside the full
   window, with its launches counted (``launches_deblur_plus_grids``) and
   its peak; every metric of the registry runs on one 720p output frame,
   with its host time; ``psnr_t`` and ``ssim_t`` on the card are held
   against the numpy ``psnr`` and ``ssim``; the deblur CLI runs with
   ``--grids --metric niqe=calculate_niqe --metric psnr=calculate_psnr
   --profile`` on a synthetic two-video folder, and its Chrome trace must
   name a kernel of the port.
9. drift: ``tools/measure_drift.py`` on its default variants
   (deblur_plus, denoise_small): bf16 on the kernels against float32 on
   the all-plain model, in dB, with each leg's peak; it fails only on a
   non-finite output.
10. bench: the port's bench entry point (``shiftnet_tpu_torch/tools/
   bench.py``, deblur_plus 720p) with one timed window; its JSON line must
   parse.
11. train: single-GPU training (``shiftnet_tpu_torch/train``).  f32
   gradients of the fused model (kernels forward, ``ops/chw_grad``'s plain
   twins backward) against the all-plain model at full width on a modest
   clip, deblur_plus and denoise_small (the whole gradient's relative L2
   error; each beside the float64 plain model's gradient, with float32
   plain's own error); after one AdamW step on the fused
   path, its forward on the kernels against the plain forward of the
   updated weights (the kept weight panels must follow the step); then
   ``tools/train.py -opt configs/gopro_deblur.yml`` on a synthetic
   23-frame folder at patch 256: 4 steps unfused and 4 with ``fused:
   true``, each with its s/step (median of the steps after the first),
   peak memory and losses, the fused step's kernel launches held against
   the forward's plus the checkpoint recompute's; a resume that logs
   "auto-resumed from step 4" and continues; two steps of
   ``configs/davis_denoise.yml`` (denoise_plus, T = 15, patch 192).
12. train_measure: the training measurement tools at the published shape
   (deblur_plus, T = 23, patch 256, bf16): ``tools/bench_train.py both 23
   256`` (one warm-up, 3 timed steps, no loader) and ``tools/
   profile_train.py fused 23 256`` (forward, backward, optimizer and loss
   glue, each with its peak; one step under ``torch.profiler``: the
   device's busy share and the top kernels), with the host's load and the
   card's clocks beside each; the ``train_measure:`` lines.
13. parallel: 2 ranks started by ``parallel/launch.py`` (gloo where they
   share this card, NCCL with a card a rank; the backend is printed, and
   which collectives it takes with CUDA tensors): (a) tp inference of
   deblur_plus 40x720x1280 bf16 on 2 ranks, the 36 gathered frames equal
   bit for bit to the single-process forward of the two 24-frame
   sub-windows of the edge rule (``parallel/temporal.py``), each rank's
   launches (``launches_tp_deblur_plus``) and peak; (b) denoise_plus
   15x480x848 f32 on 2 ranks (shards of 8 and 7 frames), bit for bit the
   same way; (c) f32 gradients of sequence-parallel deblur_plus on the
   kernels, 8x64x64 over 2 ranks, within 1e-5 (relative L2) of one
   process; (d) the train CLI on a copy of ``configs/gopro_deblur_tp8.yml``
   with ``time_parallel: 2`` (T = 24, patch 256), unfused and fused, 3
   steps each, with s/step and each rank's peak, the fused step's
   launches a rank (``launches_train_sp_fused``) held to the single-GPU
   step's; (e) ``configs/
   gopro_deblur_dp8.yml`` on 2 ranks, one step, within 1e-5 of one
   process at batch 2 on the same clips; (f) the train CLI under torchrun
   with one rank on NCCL, bit for bit the single-process step (T = 8).

The line before the last is a JSON object with each kernel's launches on
every driven path, its error, its times and its bound; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises before those lines.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Normalized max error max|kernel - plain| / std(plain).  float32 differs by
# summation order only.  In bfloat16 the kernels and the plain ops sum in
# different orders in float32, so single-ulp rounding flips land on some of
# the largest of the ~10^8 outputs: one bf16 ulp (2^-7 relative) at
# max|p| ~ 6 std(p) is 0.03-0.05 std(p).  up_skip also rounds at other
# points (its 1x1 conv runs before the upsample).  An output with a heavier
# tail has its largest values further out: naf_gate's g = d[:n] * d[n:] is a
# product of two such values, max|g| ~ 20 std(g), where one ulp is ~0.16
# std(g).  So the bf16 max bound is one ulp at the largest plain output,
# 2^-7 max|p| / std(p), and never under 5e-2.  The normalized mean error
# must stay under half a bf16 ulp, so a systematic error cannot hide under
# the max bound.  shift_round only copies and is held bit for bit.
TOL = {'float32': 1e-4, 'bfloat16': 5e-2}
BF16_ULP = 2.0 ** -7
MEAN_TOL = {'float32': 1e-6, 'bfloat16': 2 ** -8}
SLICE_TOL_F32 = 1e-3  # whole model: ~400 convs of float32 reordering
T_CHECK = 4
HALO = 2
ONE_LEN = 36
H, W = 720, 1280
# Published H100 SXM rates (NVIDIA data sheet): device memory, and the
# dense peak for the operands' type (bf16 on the tensor cores; float32 outside
# them, the data sheet's float32 rate, also for 3xTF32 kernels).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bfloat16': 989e12, 'float32': 67e12}
# Kernel launches of one deblur_plus window on the fused_chw path: 10 TFR
# U-Nets x (16 CABs, 2 down convs, 2 up_skips); feat_extract's CAB and
# Encoder2's 11 CABs; feat_extract, conv_trans, down01, down12, down23,
# upsample_conv, conv_hr0, rconcat and conv_last; up32 and up21; 7 shift
# blocks x 8 rounds x (1 shift, CAB2 + CAB1 x 3 kernels).
MAIN_PATH_LAUNCHES = {'cab_front': 172, 'cab_back': 172, 'conv': 29,
                      'up_skip': 22, 'shift_round': 56, 'naf_gate': 112,
                      'naf_rep': 112, 'naf_back': 112, 'conv_cat': 0}
# The fused_tfr configuration (the TFR U-Nets' kernels only), still driven:
# 10 TFR U-Nets x (16 CABs, 2 down convs, 2 up_skips).
TFR_PATH_LAUNCHES = {'cab_front': 160, 'cab_back': 160, 'conv': 20,
                     'up_skip': 20, 'shift_round': 0, 'naf_gate': 0,
                     'naf_rep': 0, 'naf_back': 0, 'conv_cat': 0}
# denoise_plus on the fused_chw path: Encoder2's 13 CABs are the deblur 11
# and its 4 ShiftCABs (levels 0 and 1) in place of the 2 level-1 CABs.
DENOISE_LAUNCHES = dict(MAIN_PATH_LAUNCHES, cab_front=174, cab_back=174)
# deblur_small and denoise_small on the fused_chw path: 6 TFR U-Nets x (16
# CABs, 2 down convs, 2 up_skips); feat_extract's CAB and Encoder2's concat,
# skip_attn1, skip_conv and out_conv; feat_extract, conv_trans, down01,
# down12, upsample_conv, conv_hr0, rconcat and conv_last; up21; 12 shift
# blocks x 4 rounds x (1 shift, CAB2 + CAB1 x 3 kernels).  Every naf_rep
# launch here is the depthwise form.
SMALL_LAUNCHES = {'cab_front': 101, 'cab_back': 101, 'conv': 20,
                  'up_skip': 13, 'shift_round': 48, 'naf_gate': 96,
                  'naf_rep': 96, 'naf_back': 96, 'conv_cat': 0}


def with_conv_concat(launches, folded=2):
    """The conv_concat configuration: the ``folded`` convs over a concat
    (rconcat, and conv_hr0 except under deblur_small's add-fuse) go from
    conv to one conv_cat launch each."""
    return dict(launches, conv=launches['conv'] - folded, conv_cat=folded)


# The denoise protocol (the JAX package's tools/bench_denoise.py): 480x848,
# one_len 12 + 2+2 halo, sigma 10/255, float32; a DAVIS-length window of
# 50 outputs; a DAVIS-width frame (854 cropped to a multiple of 4).
DN_H, DN_W = 480, 848
DN_T = 12 + 2 * HALO
DN_T_DAVIS = 50 + 2 * HALO
DN_W_DAVIS = 852
SIGMA = 10.0 / 255.0
# The validation protocol (``Evaluator.forward_grids``): the reference's
# crop of 256; the float32 check's window, crop and transforms (6 crops of
# 128, a multiple of 16 so every U-Net level stays whole, x 8 transforms).
GRID_CROP = 256
GRID_CHECK = (2 * HALO + 1, 256, 384, 128, 8)
GRID_SQUARE = 384  # the frame-covering crop's square window
CLI_FRAME = (256, 384)  # the validation CLI's frames (NIQE needs 96x96)

# Each row of the kernels line: (source, the TPU kernel it replaces, another
# it also replaces, the launch counter, the path whose launches it reports).
# The depthwise naf_rep is a form of its own of the naf_rep kernel (one
# template of csrc/naf_rep.cu), counted under naf_rep: its row reports the
# small variants' naf_rep launches, and the grouped row the others'.
SMALL_PATHS = ('deblur_small', 'denoise_small')
KERNELS = {
    'cab_front': ('shiftnet_tpu_torch/csrc/cab_front.cu',
                  'shiftnet_tpu/ops/chw.py:289',
                  'shiftnet_tpu/ops/chw.py:654', 'cab_front', 'fused_chw'),
    'cab_back': ('shiftnet_tpu_torch/csrc/cab_back.cu',
                 'shiftnet_tpu/ops/chw.py:378', None, 'cab_back',
                 'fused_chw'),
    'conv': ('shiftnet_tpu_torch/csrc/conv.cu',
             'shiftnet_tpu/ops/chw.py:865', None, 'conv', 'fused_chw'),
    'up_skip': ('shiftnet_tpu_torch/csrc/up_skip.cu',
                'shiftnet_tpu/ops/chw.py:1195', None, 'up_skip',
                'fused_chw'),
    'shift_round': ('shiftnet_tpu_torch/csrc/shift_round.cu',
                    'shiftnet_tpu/ops/naf_chw.py:265', None, 'shift_round',
                    'fused_chw'),
    'naf_gate': ('shiftnet_tpu_torch/csrc/naf_gate.cu',
                 'shiftnet_tpu/ops/naf_chw.py:685', None, 'naf_gate',
                 'fused_chw'),
    'naf_rep': ('shiftnet_tpu_torch/csrc/naf_rep.cu',
                'shiftnet_tpu/ops/naf_chw.py:909', None, 'naf_rep',
                'fused_chw'),
    'naf_rep_depthwise': ('shiftnet_tpu_torch/csrc/naf_rep.cu',
                          'shiftnet_tpu/ops/naf_chw.py:909', None, 'naf_rep',
                          'deblur_small'),
    'naf_back': ('shiftnet_tpu_torch/csrc/naf_back.cu',
                 'shiftnet_tpu/ops/naf_chw.py:1019', None, 'naf_back',
                 'fused_chw'),
    'conv_cat': ('shiftnet_tpu_torch/csrc/conv_cat.cu',
                 'shiftnet_tpu/ops/chw.py:906', None, 'conv_cat',
                 'conv_concat'),
}


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port has no CPU '
                         'path to smoke-test')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} '
          f'count {torch.cuda.device_count()}', flush=True)
    return card


# The kernel templates that run on the tensor cores (mma.sync), by name in
# the SASS: every instantiation must hold HMMA instructions.
MMA_KERNELS = ('cab_front_mma_kernel', 'conv_mma_kernel',
               'conv_cat_mma_kernel', 'naf_gate_mma_kernel',
               'naf_rep_mma_kernel', 'naf_back_mma_kernel',
               'up_skip_mma_kernel')
# (label, what names the functions, the SASS opcode each must hold).
SASS_CHECKS = (
    *((name, (name,), 'HMMA') for name in MMA_KERNELS),
    ('cab_back 16-byte route', ('cab_back_kernel', 'uint4'), 'LDG.E.128'),
    ('staged copy on the TMA', ('block_copy_tma_kernel',), 'UTMALDG'),
    ('staged copy on the TMA', ('block_copy_tma_kernel',), 'UTMASTG'),
    ('mm_loop on wgmma', ('mm_loop_kernel',), 'HGMMA'),
    ('mm_loop on wgmma', ('mm_loop_kernel',), 'UTMALDG'),
    ('direct copy 16-byte route', ('block_copy_kernel', 'uint4'),
     'LDG.E.128'),
)
# (label, what names the functions, the SASS opcode none may hold).
SASS_ABSENT = (
    ('mm_loop on wgmma', ('mm_loop_kernel',), 'HMMA'),
)
# Kernels that must not spill registers (ptxas -v, _build.ptxas_report).
NO_SPILL = ('mm_loop_kernel', 'block_copy_kernel')
# The wgmma tile (BM x BN) mm_loop must launch at each (m, k, n) of the
# probes phase: the tile ops/probes.mm_plan picks, fixed here so that a
# change of the planner shows.
MM_TILES = {(8192, 512, 512): '128x64', (10240, 216, 24): '128x24',
            (1440000, 120, 160): '128x160', (1296000, 96, 128): '128x64'}


def _sass_counts(lib, checks):
    """[(label, opcode, [count in each instantiation])] for ``checks``,
    from the SASS of the built library (``cuobjdump -sass``); an opcode
    counts with its modifiers (``LDG.E.128.CONSTANT`` is an
    ``LDG.E.128``)."""
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, check=True).stdout
    functions = []  # (name line, [instruction lines])
    for line in sass.splitlines():
        if 'Function :' in line:
            functions.append((line, []))
        elif functions:
            functions[-1][1].append(line)
    out = []
    for label, keys, op in checks:
        pat = re.compile(re.escape(op).replace(r'\.', r'[.\w]*\.') + r'\b')
        out.append((label, op, [
            sum(1 for ln in body if pat.search(ln))
            for name, body in functions if all(k in name for k in keys)]))
    return out


def build_phase():
    from shiftnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.library()
    dt = time.perf_counter() - t0
    print(f'build: {path.name} ready in {dt:.2f} s', flush=True)
    for label, op, counts in _sass_counts(path, SASS_CHECKS):
        print(f'build: {label}: {len(counts)} instantiations, {op} '
              f'instructions in SASS {sum(counts)} (each {counts})',
              flush=True)
        if not counts or min(counts) == 0:
            raise AssertionError(f'{label}: an instantiation has no {op} '
                                 'instruction')
    for label, op, counts in _sass_counts(path, SASS_ABSENT):
        print(f'build: {label}: {len(counts)} instantiations, {op} '
              f'instructions in SASS {sum(counts)} (none allowed)',
              flush=True)
        if not counts or max(counts) != 0:
            raise AssertionError(f'{label}: an instantiation holds {op}')
    report = _build.ptxas_report()
    spills = {k: v for k, v in report.items() if v['spill'] or v['serial']}
    for key in NO_SPILL:
        regs = sorted({v['registers'] for k, v in report.items() if key in k})
        print(f'build: ptxas -v: {key}: {sum(key in k for k in report)} '
              f'functions, registers {regs}', flush=True)
    print(f'build: ptxas -v: {len(report)} functions, spills or serialized '
          f'wgmma in {sorted(spills) or "none"}', flush=True)
    bad = [k for k in spills if any(key in k for key in NO_SPILL)]
    if bad:
        raise AssertionError(f'spilled or serialized: {bad}')
    return dt


def _median_ms(fn, n=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _norm_err(k, p):
    """(normalized max error, normalized mean error, max abs error,
    max|p| / std(p))."""
    d = (k.double() - p.double()).abs()
    sd = p.double().std()
    return (float(d.max() / sd), float(d.mean() / sd), float(d.max()),
            float(p.double().abs().max() / sd))


def _max_tol(dtn, tail):
    """The normalized max error bound for an output whose largest value is
    ``tail`` standard deviations out (see TOL)."""
    if dtn == 'bfloat16':
        return max(TOL[dtn], BF16_ULP * tail)
    return TOL[dtn]


def _rate(ops, ms):
    """`` (x TF/s)`` for a kernel that computes, else empty."""
    return f' ({ops / ms / 1e9:.1f} TF/s)' if ops else ''


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


class Case:
    """One kernel call: ``kernel`` and ``plain`` compute the same function
    on ``inputs``; ``ops`` counts its arithmetic (2 per multiply-add);
    ``library`` is one PyTorch call computing it, or None.  ``exact``:
    held bit for bit; ``also``: other kernel calls of the same function
    (in place), held bit for bit; ``route``: (the route the kernel takes,
    the route it must take)."""

    def __init__(self, kernel, plain, inputs, ops, library=None,
                 exact=False, also=(), route=None):
        self.kernel, self.plain, self.inputs = kernel, plain, inputs
        self.ops, self.library, self.exact = ops, library, exact
        self.also, self.route = also, route


def _back_case(arr, unit, c, h, w):
    """cab_back at C x h x w (T = 4): bit for bit, fresh and in place, on
    the 16-byte route, beside ``torch.addcmul``."""
    import torch
    from shiftnet_tpu_torch.ops import chw

    def back(rng, dt):
        x = arr(rng, (T_CHECK, c, h, w), dt)
        s = arr(rng, (T_CHECK, c, h, w), dt)
        ca = unit(rng, (T_CHECK, c), dt)
        return Case(lambda: chw.cab_back(x, s, ca),
                    lambda: chw.cab_back_plain(x, s, ca),
                    [x, s, ca], 2 * x.numel(),
                    lambda: torch.addcmul(x, s, ca[:, :, None, None]),
                    exact=True,
                    also=(lambda: chw.cab_back(x.clone(), s, ca,
                                               inplace=True),),
                    route=(chw.cab_back_route(x, s, x), 'vector'))
    return back


def _cases():
    """(kernel name, label, make(rng, dtype) -> Case), the largest
    main-path shape of each kernel first."""
    import torch
    import torch.nn.functional as F
    from shiftnet_tpu_torch.models import init_state, layers
    from shiftnet_tpu_torch.ops import chw, naf_chw

    def arr(rng, shape, dtype, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(
            'cuda', dtype)

    def wgt(rng, shape, dtype):
        bound = 1.0 / np.sqrt(np.prod(shape[1:]))
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(
            np.float32)).to('cuda', dtype)

    def f32(rng, shape, scale):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()

    def unit(rng, shape, dtype):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(
            np.float32)).to('cuda', dtype)

    def naf_prep(rng, n, cab2, dtype, opts=False, depthwise=False):
        """prep_naf of a seeded CAB2 / CAB1 whose LayerNorm is not the
        identity (LN of a zero pixel is then nonzero, so the halo masks
        matter) and, with ``opts``, a nonzero last bias; ``depthwise``: the
        small variants' depthwise RepConv."""
        kw = dict(kernel_size=5, reduction=4, mid_ca=opts, last_bias=opts,
                  repconv_depthwise=depthwise)
        mod = (layers.CAB2(n, n // 2, **kw) if cab2
               else layers.CAB1(n, **kw))
        state = init_state(mod, int(rng.integers(1 << 30)))
        for key, v in state.items():
            if key.startswith('norm.') or key.endswith('.bias'):
                state[key] = v + torch.from_numpy(
                    0.3 * rng.standard_normal(v.shape).astype(np.float32))
            elif key == 'beta':
                state[key] = torch.from_numpy(
                    rng.standard_normal(v.shape).astype(np.float32))
        mod.load_state_dict(state, strict=True)
        p = {k: v.detach().cuda() for k, v in mod.named_parameters()}
        return naf_chw.prep_naf(p, '', dtype, mid_ca=opts, last_bias=opts)

    cases = []
    levels = ((H // 2, W // 2), (H // 4, W // 4), (H // 8, W // 8))
    n, add_c, number = 80, 40, 5

    # -- rows 1-3: cab_front, cab_back (TFR widths, then Encoder2's C=80)
    for c, h, w in ((24, H, W), (36, H // 2, W // 2), (48, H // 4, W // 4),
                    (80, H // 2, W // 2)):
        def front(rng, dt, c=c, h=h, w=w):
            x = arr(rng, (T_CHECK, c, h, w), dt)
            w1, w2 = wgt(rng, (c, c, 3, 3), dt), wgt(rng, (c, c, 3, 3), dt)
            alpha = torch.full((1,), 0.25, device='cuda')
            return Case(lambda: chw.cab_front(x, w1, alpha, w2),
                        lambda: chw.cab_front_plain(x, w1, alpha, w2),
                        [x, w1, alpha, w2], 2 * 2 * 9 * c * c * x[:, 0].numel())

        cases.append(('cab_front', f'C={c} {h}x{w}', front))
        cases.append(('cab_back', f'C={c} {h}x{w}',
                      _back_case(arr, unit, c, h, w)))

    # -- row 4: conv (TFR downsamples, then the standalone convs)
    conv_shapes = (  # cin, cout, k, stride, bias, prelu, h, w
        (24, 36, 3, 2, True, False, H, W),
        (36, 48, 3, 2, True, False, H // 2, W // 2),
        (24, 24, 3, 1, False, True, H // 2, W // 2),
        (24, 3, 5, 1, False, False, H, W),             # conv_last
        (3, 24, 3, 1, True, False, H, W),              # feat_extract
        (24, 80, 2, 2, False, True, H, W),             # down01
        (80, 96, 3, 1, True, False, H // 2, W // 2),   # upsample_conv
        (72, 24, 3, 1, True, False, H, W),             # rconcat
    )
    for cin, cout, k, st, bias, pre, h, w in conv_shapes:
        def cv(rng, dt, cin=cin, cout=cout, k=k, st=st, bias=bias, pre=pre,
               h=h, w=w):
            x = arr(rng, (T_CHECK, cin, h, w), dt)
            wt = wgt(rng, (cout, cin, k, k), dt)
            b = f32(rng, (cout,), 0.01) if bias else None
            a = torch.full((1,), 0.25, device='cuda') if pre else None
            pad = chw.conv_pad(k, st)
            n_out = T_CHECK * ((h + 2 * pad - k) // st + 1) * (
                (w + 2 * pad - k) // st + 1)
            lib = None
            if not pre:
                bl = None if b is None else b.to(dt)
                lib = lambda: F.conv2d(x, wt, bl, st, pad)  # noqa: E731
            return Case(lambda: chw.conv(x, wt, b, a, st),
                        lambda: chw.conv_plain(x, wt, b, a, st),
                        [x, wt, b, a], 2 * k * k * cin * cout * n_out, lib)
        cases.append(('conv', f'{cin}->{cout} k{k} s{st}'
                      f'{" bias" if bias else ""}{" prelu" if pre else ""}'
                      f' {h}x{w}', cv))

    # -- row 5: conv_cat (deblur rconcat and conv_hr0, denoise rconcat; the
    # small variants' widths: deblur_small rconcat, denoise_small conv_hr0);
    # the library call is F.conv2d on the input already concatenated (the
    # cat not timed), and none with the PReLU
    for n_in, c, bias, pre, h, w in ((3, 24, True, False, H, W),
                                     (2, 24, True, False, H, W),
                                     (3, 24, False, True, DN_H, DN_W),
                                     (3, 14, True, False, H, W),
                                     (2, 14, True, False, DN_H, DN_W)):
        def cat(rng, dt, n_in=n_in, c=c, bias=bias, pre=pre, h=h, w=w):
            xs = [arr(rng, (T_CHECK, c, h, w), dt) for _ in range(n_in)]
            wt = wgt(rng, (c, c * n_in, 3, 3), dt)
            b = f32(rng, (c,), 0.01) if bias else None
            a = torch.full((1,), 0.25, device='cuda') if pre else None
            lib = None
            if not pre:
                xcat = torch.cat(xs, 1)
                bl = None if b is None else b.to(dt)
                lib = lambda: F.conv2d(xcat, wt, bl, 1, 1)  # noqa: E731
            return Case(lambda: chw.conv_concat(xs, wt, b, a),
                        lambda: chw.conv_concat_plain(xs, wt, b, a),
                        [*xs, wt, b, a],
                        2 * 9 * c * n_in * c * T_CHECK * h * w, lib)
        cases.append(('conv_cat', f'{n_in}x{c}->{c}'
                      f'{" bias" if bias else ""}{" prelu" if pre else ""}'
                      f' {h}x{w}', cat))

    # -- row 6: up_skip (TFR, then Encoder2's up21 / up32 at C=80)
    for cin, cout, h, w in ((36, 24, H // 2, W // 2),
                            (48, 36, H // 4, W // 4),
                            (80, 80, H // 4, W // 4)):
        def up(rng, dt, cin=cin, cout=cout, h=h, w=w):
            x = arr(rng, (T_CHECK, cin, h, w), dt)
            w11 = wgt(rng, (cout, cin, 1, 1), dt)
            skip = arr(rng, (T_CHECK, cout, 2 * h, 2 * w), dt)
            return Case(lambda: chw.up_skip(x, w11, skip),
                        lambda: chw.up_skip_plain(x, w11, skip),
                        [x, w11, skip], 2 * cin * cout * T_CHECK * h * w)
        cases.append(('up_skip', f'{cin}->{cout} {h}x{w}->{2 * h}x{2 * w}',
                      up))

    # -- rows 7-10: the shift-block kernels at the three Encoder2 levels
    for h, w in levels:
        for reverse in (False, True):
            def shift(rng, dt, h=h, w=w, reverse=reverse):
                x = arr(rng, (T_CHECK, n, h, w), dt)
                kw = dict(reverse=reverse, boundary_patch=True)
                return Case(lambda: naf_chw.shift_round(x, number, **kw),
                            lambda: naf_chw.shift_round_plain(x, number,
                                                              **kw),
                            [x], 0, exact=True)
            cases.append(('shift_round', f'C={n} {h}x{w} '
                          f'{"reverse" if reverse else "forward"} patch',
                          shift))
        for cab2 in (True, False):
            def gate(rng, dt, h=h, w=w, cab2=cab2):
                prep = naf_prep(rng, n, cab2, dt)
                y = arr(rng, (T_CHECK, n, h, w), dt)
                hw = arr(rng, (T_CHECK, add_c, h, w), dt) if cab2 else None
                cin = n + (add_c if cab2 else 0)
                px = T_CHECK * h * w
                used = [prep[k] for k in ('wg_p', 'c1', 'c2', 'dw0', 'dwc')]
                return Case(lambda: naf_chw.naf_gate(y, hw, prep),
                            lambda: naf_chw.naf_gate_plain(y, hw, prep),
                            [y, hw, *used],
                            2 * px * (2 * n * cin + 9 * (cin - n) + 9 * 2 * n)
                            + px * n)
            cases.append(('naf_gate', f'{"CAB2" if cab2 else "CAB1"} n={n} '
                          f'{h}x{w}', gate))
        for opts in ((False, True) if h == H // 2 else (False,)):
            def rep(rng, dt, h=h, w=w, opts=opts):
                prep = naf_prep(rng, n, True, dt)
                g = arr(rng, (T_CHECK, n, h, w), dt)
                cag = unit(rng, (T_CHECK, n), dt) if opts else None
                return Case(lambda: naf_chw.naf_rep(g, cag, prep),
                            lambda: naf_chw.naf_rep_plain(g, cag, prep),
                            [g, cag, prep['rep_p'], prep['w4_p']],
                            2 * T_CHECK * h * w * (25 * 8 * n + 2 * n * n))

            def back(rng, dt, h=h, w=w, opts=opts):
                prep = naf_prep(rng, n, False, dt, opts=opts)
                y = arr(rng, (T_CHECK, n, h, w), dt)
                s = arr(rng, (T_CHECK, n, h, w), dt)
                ca = unit(rng, (T_CHECK, n), dt)
                return Case(lambda: naf_chw.naf_back(y, s, ca, prep),
                            lambda: naf_chw.naf_back_plain(y, s, ca, prep),
                            [y, s, ca, prep['w7_p'], prep['beta'],
                             prep['b7']],
                            2 * T_CHECK * h * w * n * n)
            cases.append(('naf_rep', f'n={n} {h}x{w}'
                          f'{" cag" if opts else ""}', rep))
            cases.append(('naf_back', f'n={n} {h}x{w}'
                          f'{" b7" if opts else ""}', back))
    cases += _small_cases(arr, wgt, unit, naf_prep)
    return cases


def _small_cases(arr, wgt, unit, naf_prep):
    """The small variants' shapes at 720p (T = 4): the depthwise naf_rep at
    n = 64 (its own row; with the mid-CALayer scale of denoise_small too),
    then the other kernels at the widths these variants add (TFR widths 14,
    18 and 22, Encoder2 width 64, add_c 32)."""
    import torch
    import torch.nn.functional as F
    from shiftnet_tpu_torch.ops import chw, naf_chw

    cases = []
    n, h, w = 64, H // 2, W // 2
    for opts in (False, True):
        def rep(rng, dt, opts=opts):
            prep = naf_prep(rng, n, True, dt, depthwise=True)
            g = arr(rng, (T_CHECK, n, h, w), dt)
            cag = unit(rng, (T_CHECK, n), dt) if opts else None
            return Case(lambda: naf_chw.naf_rep(g, cag, prep),
                        lambda: naf_chw.naf_rep_plain(g, cag, prep),
                        [g, cag, prep['rep'], prep['w4_p']],
                        2 * T_CHECK * h * w * (25 * n + 2 * n * n))
        cases.append(('naf_rep_depthwise',
                      f'n={n} {h}x{w}{" cag" if opts else ""}', rep))

    for c, hc, wc in ((14, H, W), (18, H // 2, W // 2), (22, H // 4, W // 4),
                      (64, h, w)):
        def front(rng, dt, c=c, hc=hc, wc=wc):
            x = arr(rng, (T_CHECK, c, hc, wc), dt)
            w1, w2 = wgt(rng, (c, c, 3, 3), dt), wgt(rng, (c, c, 3, 3), dt)
            alpha = torch.full((1,), 0.25, device='cuda')
            return Case(lambda: chw.cab_front(x, w1, alpha, w2),
                        lambda: chw.cab_front_plain(x, w1, alpha, w2),
                        [x, w1, alpha, w2],
                        2 * 2 * 9 * c * c * x[:, 0].numel())
        cases.append(('cab_front', f'C={c} {hc}x{wc}', front))
        cases.append(('cab_back', f'C={c} {hc}x{wc}',
                      _back_case(arr, unit, c, hc, wc)))

    for cin, cout, k, st, pre, hc, wc in (
            (14, 64, 2, 2, True, H, W),             # down01
            (64, 56, 3, 1, False, h, w),            # upsample_conv
            (14, 14, 3, 1, False, H, W),            # add-fuse conv_hr0
            (3, 14, 3, 1, False, H, W),             # feat_extract
            (14, 3, 5, 1, False, H, W)):            # conv_last
        def cv(rng, dt, cin=cin, cout=cout, k=k, st=st, pre=pre, hc=hc,
               wc=wc):
            x = arr(rng, (T_CHECK, cin, hc, wc), dt)
            wt = wgt(rng, (cout, cin, k, k), dt)
            a = torch.full((1,), 0.25, device='cuda') if pre else None
            n_out = T_CHECK * (hc // st) * (wc // st)
            lib = None if pre else (
                lambda: F.conv2d(x, wt, None, st, chw.conv_pad(k, st)))
            return Case(lambda: chw.conv(x, wt, None, a, st),
                        lambda: chw.conv_plain(x, wt, None, a, st),
                        [x, wt, a], 2 * k * k * cin * cout * n_out, lib)
        cases.append(('conv', f'{cin}->{cout} k{k} s{st}'
                      f'{" prelu" if pre else ""} {hc}x{wc}', cv))

    def up(rng, dt):
        x = arr(rng, (T_CHECK, 18, H // 4, W // 4), dt)
        w11 = wgt(rng, (14, 18, 1, 1), dt)
        skip = arr(rng, (T_CHECK, 14, H // 2, W // 2), dt)
        return Case(lambda: chw.up_skip(x, w11, skip),
                    lambda: chw.up_skip_plain(x, w11, skip),
                    [x, w11, skip], 2 * 18 * 14 * x[:, 0].numel())
    cases.append(('up_skip', f'18->14 {H // 4}x{W // 4}->{h}x{w}', up))

    def shift(rng, dt):
        x = arr(rng, (T_CHECK, n, h, w), dt)
        kw = dict(reverse=False, boundary_patch=False)
        return Case(lambda: naf_chw.shift_round(x, 4, **kw),
                    lambda: naf_chw.shift_round_plain(x, 4, **kw),
                    [x], 0, exact=True)
    cases.append(('shift_round', f'C={n} {h}x{w} forward no patch', shift))

    def gate(rng, dt):
        prep = naf_prep(rng, n, True, dt, depthwise=True)
        y = arr(rng, (T_CHECK, n, h, w), dt)
        hw = arr(rng, (T_CHECK, n // 2, h, w), dt)
        used = [prep[k] for k in ('wg_p', 'c1', 'c2', 'dw0', 'dwc')]
        px, cin = T_CHECK * h * w, n + n // 2
        return Case(lambda: naf_chw.naf_gate(y, hw, prep),
                    lambda: naf_chw.naf_gate_plain(y, hw, prep),
                    [y, hw, *used],
                    2 * px * (2 * n * cin + 9 * (cin - n) + 9 * 2 * n)
                    + px * n)
    cases.append(('naf_gate', f'CAB2 n={n} {h}x{w}', gate))

    def back(rng, dt):
        prep = naf_prep(rng, n, False, dt, opts=True, depthwise=True)
        y = arr(rng, (T_CHECK, n, h, w), dt)
        s = arr(rng, (T_CHECK, n, h, w), dt)
        ca = unit(rng, (T_CHECK, n), dt)
        return Case(lambda: naf_chw.naf_back(y, s, ca, prep),
                    lambda: naf_chw.naf_back_plain(y, s, ca, prep),
                    [y, s, ca, prep['w7_p'], prep['beta'], prep['b7']],
                    2 * T_CHECK * h * w * n * n)
    cases.append(('naf_back', f'n={n} {h}x{w} b7', back))
    return cases


def kernel_phase(card):
    """Each kernel against its plain version; returns per-kernel records
    (the bf16 times and bound of each kernel's first case)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'kernels: normalized max error tolerance {TOL}, normalized mean '
          f'error tolerance {MEAN_TOL}; shift_round bit for bit', flush=True)
    rec = {name: {'max_abs_err': 0.0} for name in KERNELS}
    failed = []
    for i, (name, label, make) in enumerate(_cases()):
        for dtn in ('float32', 'bfloat16'):
            dt = getattr(torch, dtn)
            rng = np.random.default_rng(1000 + i)
            case = make(rng, dt)
            with torch.inference_mode():
                k_out = _outputs(case.kernel())
                p_out = _outputs(case.plain())
                torch.cuda.synchronize()
                errs = [_norm_err(a, b) for a, b in zip(k_out, p_out)]
                worst = max(errs, key=lambda e: e[0] / _max_tol(dtn, e[3]))
                err, tol = worst[0], _max_tol(dtn, worst[3])
                mean_err = max(e[1] for e in errs)
                abs_err = max(e[2] for e in errs)
                if case.exact:
                    ok = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
                else:
                    ok = all(e[0] <= _max_tol(dtn, e[3])
                             and e[1] <= MEAN_TOL[dtn] for e in errs)
                for other in case.also:
                    ok &= all(torch.equal(a, b)
                              for a, b in zip(_outputs(other()), p_out))
                route = ''
                if case.route:
                    route = f' route {case.route[0]}'
                    ok &= case.route[0] == case.route[1]
                ms = _median_ms(case.kernel)
                pms = _median_ms(case.plain)
                lms = None if case.library is None else _median_ms(
                    case.library)
            nbytes = _nbytes(case.inputs) + _nbytes(k_out)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * case.ops / PEAK_OPS_PER_S[dtn]
            bound = max(t_bytes, t_ops)
            print(f'kernel {name:11s} {label:36s} {dtn:8s} err {err:.3e} '
                  f'(tol {tol:.2e}) mean {mean_err:.2e} '
                  f'{"ok" if ok else "FAIL"}{route}  kernel '
                  f'{ms:.3f} ms{_rate(case.ops, ms)}  plain {pms:.3f} ms  '
                  f'library '
                  f'{"none" if lms is None else f"{lms:.3f} ms"}  bound '
                  f'{bound:.3f} ms ({nbytes / 1e6:.1f} MB, '
                  f'{case.ops / 1e9:.1f} GFLOP)  [{card}]', flush=True)
            if not ok:
                failed.append(f'{name} {label} {dtn}')
            r = rec[name]
            if dtn == 'bfloat16':
                r['max_abs_err'] = max(r['max_abs_err'], abs_err)
                if 'ms' not in r:  # first case: the largest main-path shape
                    r.update(ms=ms, plain_ms=pms, library_ms=lms,
                             bound_ms=bound,
                             bound_by='bytes' if t_bytes >= t_ops
                             else 'operations')
            del case, k_out, p_out
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f'kernels disagree with their plain versions: '
                             f'{failed}')
    return rec


def _clip(t, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (t, h, w, 3)).astype(np.float32)


def _drive(ev, clip, expected, label, card, timed, sigma=None):
    """One window through ``ev.forward_window`` with the launch counts set
    to 0 just before and read just after, then ``timed`` timed windows;
    the peak device memory of all of them is held against the window
    plan's estimate.  Returns the counts, the window times, the peak and
    the first window's output."""
    import torch
    from shiftnet_tpu_torch.ops import chw

    t, h, w = clip.shape[:3]
    plan = ev.window_plan(clip.shape)
    estimate = t * h * w * ev.bytes_per_px
    print(f'slice: {label} window {clip.shape} plan {plan}, estimated peak '
          f'{estimate / 1e9:.3f} GB ({ev.bytes_per_px} B/px)', flush=True)
    torch.cuda.reset_peak_memory_stats()
    chw.reset_launches()
    out = ev.forward_window(clip, sigma)
    launches = dict(chw.LAUNCHES)
    print(f'slice: {label} launches {launches}', flush=True)
    if out.shape != (t - 2 * HALO, h, w, 3):
        raise AssertionError(f'{label}: output shape {out.shape}')
    if not np.isfinite(out).all():
        raise AssertionError(f'{label}: non-finite output')
    if launches != expected:
        raise AssertionError(f'{label}: launches {launches}, expected '
                             f'{expected}')
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        ev.forward_window(clip, sigma)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    fps = timed * (t - 2 * HALO) / sum(times)
    dtn = str(ev.dtype).split('.')[-1]
    print(f'slice: {label} {dtn} window T={t} {h}x{w} plan {plan}: '
          f'{fps:.4f} fps (windows {", ".join(f"{s:.3f}" for s in times)} '
          f's) peak {peak / 1e9:.3f} GB = {peak / (t * h * w):.0f} B/px '
          f'against the estimate {estimate / 1e9:.3f} GB [{card}]',
          flush=True)
    if peak > estimate:
        raise AssertionError(f'{label}: the window plan underestimates the '
                             'peak')
    return launches, times, peak, out


def _pair(label, off, on, card):
    """conv_concat off and on, side by side: mean window time and peak."""
    print(f'pair: {label}: conv_concat off {statistics.mean(off[1]):.3f} s '
          f'peak {off[2] / 1e9:.3f} GB | on {statistics.mean(on[1]):.3f} s '
          f'peak {on[2] / 1e9:.3f} GB [{card}]', flush=True)


def _whole_model(variant, state, clip, sigma, names, dtypes, logs):
    """The model on the kernels against the all-plain model on one small
    window: {(configuration, dtype name): normalized max error}."""
    import torch
    from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for dtn in dtypes:
        outs = {}
        for name in ('plain', *names):
            ev = Evaluator(variant, state, device='cuda',
                           bf16=dtn == 'bfloat16',
                           overrides=CONFIG_OVERRIDES[name], result_path=logs)
            outs[name] = torch.from_numpy(ev.forward_window(clip, sigma))
            del ev
            torch.cuda.empty_cache()
        for name in names:
            res[name, dtn] = _norm_err(outs[name], outs['plain'])[0]
    t, h, w = clip.shape[:3]
    for name in names:
        print(f'slice: {variant} {name} model vs all-plain model, {t}x{h}x{w}'
              ': ' + ', '.join(f'{dtn} err {res[name, dtn]:.3e}'
                               for dtn in dtypes)
              + f' (float32 tol {SLICE_TOL_F32:.0e})', flush=True)
        if not res[name, 'float32'] <= SLICE_TOL_F32:
            raise AssertionError(f'the {variant} {name} model disagrees with '
                                 'the plain model')
    return res


def deblur_phase(card, logs):
    """deblur_plus 40x720x1280 bf16 windows through the port's default
    Evaluator (``fused_chw``, the main path), the ``conv_concat``
    configuration and the ``fused_tfr`` configuration, each with its own
    launch counts; then the whole model in each configuration against the
    all-plain model.  Returns the launches of each path and the default
    window's fps."""
    import torch
    from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator
    from shiftnet_tpu_torch.models import build_model, init_state

    state = init_state(build_model('deblur_plus'), seed=0)
    clip = _clip(ONE_LEN + 2 * HALO, H, W, seed=1)
    runs = {}
    for name, overrides, expected, timed in (
            ('fused_chw', None, MAIN_PATH_LAUNCHES, 3),  # the default
            ('conv_concat', CONFIG_OVERRIDES['conv_concat'],
             with_conv_concat(MAIN_PATH_LAUNCHES), 1),
            ('fused_tfr', CONFIG_OVERRIDES['fused_tfr'], TFR_PATH_LAUNCHES,
             1)):
        ev = Evaluator('deblur_plus', state, device='cuda',
                       overrides=overrides, result_path=logs)
        cfg = ev.model.cfg
        if name == 'fused_chw' and not (cfg.fused_chw and not cfg.conv_concat
                                        and ev.dtype == torch.bfloat16):
            raise AssertionError('the default deblur Evaluator is not bf16 '
                                 'fused_chw with conv_concat off')
        runs[name] = _drive(ev, clip, expected, f'deblur_plus {name}', card,
                            timed)[:3]
        del ev
        torch.cuda.empty_cache()
    _pair(f'deblur_plus {clip.shape[0]}x{H}x{W} bf16', runs['fused_chw'],
          runs['conv_concat'], card)
    _whole_model('deblur_plus', state, _clip(2 * HALO + 1, H, W, seed=2),
                 None, ('fused_chw', 'conv_concat', 'fused_tfr'),
                 ('float32', 'bfloat16'), logs)
    full = runs['fused_chw'][1]
    return ({name: run[0] for name, run in runs.items()},
            len(full) * ONE_LEN / sum(full))


def _davis_width(ev, variant, expected):
    """A DAVIS-width 16x480x852 window: it must run as four finite quadrant
    tiles, each launching what a window of the path launches."""
    from shiftnet_tpu_torch.ops import chw
    wide = _clip(DN_T, DN_H, DN_W_DAVIS, seed=5)
    plan = ev.window_plan(wide.shape)
    chw.reset_launches()
    out = ev.forward_window(wide, SIGMA)
    launches = dict(chw.LAUNCHES)
    print(f'slice: {variant} DAVIS-width window {wide.shape} plan {plan}, '
          f'launches {launches}', flush=True)
    if (plan != 'quadrant'
            or out.shape != (DN_T - 2 * HALO, DN_H, DN_W_DAVIS, 3)
            or not np.isfinite(out).all()
            or launches != {k: 4 * v for k, v in expected.items()}):
        raise AssertionError(f'the {variant} DAVIS-width window did not run '
                             'as four finite quadrant tiles')


def denoise_phase(card, logs):
    """denoise_plus through the port's default Evaluator (float32,
    ``fused_chw``, conv_concat off) on the bench_denoise window, a
    DAVIS-width window (the quadrant plan) and a DAVIS-length window, the
    two 480x848 windows also with conv_concat on; the bf16 drift, for
    information; then the whole model against the all-plain model.
    Returns the launches of each path."""
    import torch
    from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator
    from shiftnet_tpu_torch.models import build_model, init_state

    state = init_state(build_model('denoise_plus'), seed=0)
    clip = _clip(DN_T, DN_H, DN_W, seed=3)
    long = _clip(DN_T_DAVIS, DN_H, DN_W, seed=4)
    runs = {}
    for name, overrides, expected in (
            ('fused_chw', None, DENOISE_LAUNCHES),  # the default
            ('conv_concat', CONFIG_OVERRIDES['conv_concat'],
             with_conv_concat(DENOISE_LAUNCHES))):
        ev = Evaluator('denoise_plus', state, device='cuda',
                       overrides=overrides, result_path=logs)
        cfg = ev.model.cfg
        if name == 'fused_chw' and not (cfg.fused_chw and not cfg.conv_concat
                                        and ev.dtype == torch.float32):
            raise AssertionError('the default denoise Evaluator is not '
                                 'float32 fused_chw with conv_concat off')
        runs[name] = _drive(ev, clip, expected, f'denoise_plus {name}', card,
                            3, SIGMA)
        runs[name, 'long'] = _drive(ev, long, expected,
                                    f'denoise_plus {name} DAVIS-length',
                                    card, 1, SIGMA)[:3]
        if name == 'fused_chw':
            _davis_width(ev, 'denoise_plus', expected)
        del ev
        torch.cuda.empty_cache()
    _pair(f'denoise_plus {DN_T}x{DN_H}x{DN_W} float32', runs['fused_chw'],
          runs['conv_concat'], card)
    _pair(f'denoise_plus {DN_T_DAVIS}x{DN_H}x{DN_W} float32',
          runs['fused_chw', 'long'], runs['conv_concat', 'long'], card)

    # For information: the bf16 window's drift from the float32 one.
    ev = Evaluator('denoise_plus', state, device='cuda', bf16=True,
                   result_path=logs)
    out16 = np.clip(ev.forward_window(clip, SIGMA), 0, 1)
    out32 = np.clip(runs['fused_chw'][3], 0, 1)
    mse = float(np.mean((out16.astype(np.float64) - out32) ** 2))
    print(f'info: denoise_plus {DN_T}x{DN_H}x{DN_W} fused_chw bf16 vs float32 '
          f'output drift {10 * np.log10(1 / mse):.2f} dB PSNR [{card}]',
          flush=True)
    launches = {'denoise': runs['fused_chw'][0],
                'denoise_conv_concat': runs['conv_concat'][0]}
    del ev, out16, out32, runs
    torch.cuda.empty_cache()

    _whole_model('denoise_plus', state, _clip(2 * HALO + 1, DN_H, DN_W, 6),
                 SIGMA, ('fused_chw', 'conv_concat'), ('float32',), logs)
    return launches


def small_phase(card, logs):
    """deblur_small (bf16, 40x720x1280) and denoise_small (float32,
    16x480x848, sigma 10/255) through the port's default Evaluator
    (``fused_chw``, conv_concat off) on the full-window plan, and once with
    conv_concat; a DAVIS-width denoise_small window on the quadrant plan;
    then each whole model against the all-plain model on a 5-frame window.
    Returns the launches of each path."""
    import torch
    from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator
    from shiftnet_tpu_torch.models import build_model, init_state

    launches = {}
    for variant, (t, h, w), sigma, dtype, folded in (
            ('deblur_small', (ONE_LEN + 2 * HALO, H, W), None,
             torch.bfloat16, 1),  # add-fuse: conv_hr0 reads no concat
            ('denoise_small', (DN_T, DN_H, DN_W), SIGMA, torch.float32, 2)):
        state = init_state(build_model(variant), seed=0)
        clip = _clip(t, h, w, seed=7)
        runs = {}
        for name, overrides, expected, timed in (
                ('fused_chw', None, SMALL_LAUNCHES, 3),  # the default
                ('conv_concat', CONFIG_OVERRIDES['conv_concat'],
                 with_conv_concat(SMALL_LAUNCHES, folded), 1)):
            ev = Evaluator(variant, state, device='cuda',
                           overrides=overrides, result_path=logs)
            cfg = ev.model.cfg
            if name == 'fused_chw' and not (cfg.fused_chw
                                            and not cfg.conv_concat
                                            and ev.dtype == dtype):
                raise AssertionError(f'the default {variant} Evaluator is '
                                     f'not {dtype} fused_chw with '
                                     'conv_concat off')
            if ev.window_plan(clip.shape) != 'full':
                raise AssertionError(f'{variant}: the {clip.shape} window '
                                     'is not on the full-window plan')
            runs[name] = _drive(ev, clip, expected, f'{variant} {name}',
                                card, timed, sigma)[:3]
            if name == 'fused_chw' and sigma is not None:
                _davis_width(ev, variant, expected)
            del ev
            torch.cuda.empty_cache()
        _pair(f'{variant} {t}x{h}x{w} {str(dtype).split(".")[-1]}',
              runs['fused_chw'], runs['conv_concat'], card)
        launches[variant] = runs['fused_chw'][0]
        launches[f'{variant}_conv_concat'] = runs['conv_concat'][0]
        del runs
        _whole_model(variant, state, _clip(2 * HALO + 1, h, w, seed=8), sigma,
                     ('fused_chw',), ('float32',), logs)
    return launches


def _form_launches(name, path, n):
    """naf_rep's launches on a path, split by form: the depthwise row
    counts the small variants' paths, the grouped row the others."""
    if name.startswith('naf_rep'):
        small = path.startswith(SMALL_PATHS)
        return n if small == (name == 'naf_rep_depthwise') else 0
    return n


# Each probe row of the kernels line: (source, the TPU kernel it replaces,
# the launch counter of ``ops/probes.py``).  The ten probe kernels of the
# JAX package's tools/ run on four CUDA kernels.
PROBES = {
    'mm_loop': ('probe_mm.cu', 'tools/microbench_mm.py:16', 'mm_loop'),
    'copy_x2_staged': ('probe_copy.cu', 'tools/microbench.py:126',
                       'block_copy_staged'),
    'hbm_copy': ('probe_copy.cu', 'tools/probe_hbm_copy.py:29',
                 'block_copy'),
    'lane_stride': ('probe_stride.cu', 'tools/probe_chw.py:119',
                    'strided_copy'),
    'sub_stride': ('probe_stride.cu', 'tools/probe_chw.py:135',
                   'strided_copy'),
    'strided_store': ('probe_stride.cu', 'tools/probe_chw.py:152',
                      'strided_copy'),
    'permute_direct': ('probe_copy.cu', 'tools/probe_copy_bw.py:45',
                       'block_copy'),
    'permute_staged': ('probe_copy.cu', 'tools/probe_copy_bw.py:61',
                       'block_copy_staged'),
    'dma_offset': ('probe_copy.cu', 'tools/probe_dma_align.py:34',
                   'block_copy_staged'),
    'value_slice': ('probe_copy.cu', 'tools/probe_dma_align.py:64',
                    'block_copy'),
}

def _probe_drive():
    """Each probe tool through its entry point, the probe launch counts set
    to 0 just before and read just after, held against the launches the
    tool implies (each case: one checked launch, the warm-up and the timed
    runs); every tool's own checks must pass.  probe_chw's three strided
    modes share one kernel, so its three entry points run one by one.
    Returns {probe row: launches}."""
    from shiftnet_tpu_torch.ops import probes
    from shiftnet_tpu_torch.tools import (microbench, microbench_mm,
                                          probe_chw, probe_copy_bw,
                                          probe_dma_align, probe_hbm_copy)
    from shiftnet_tpu_torch.tools.timing import CASE_LAUNCHES as n

    def ok_rc(fn):
        return lambda: 0 if fn() else 1
    runs = (  # (label, entry point returning an exit code, {row: launches})
        ('microbench_mm.main', microbench_mm.main,
         {'mm_loop': n * len(microbench_mm.cases())}),
        ('microbench.main', microbench.main, {'copy_x2_staged': n}),
        ('probe_hbm_copy.main', probe_hbm_copy.main, {'hbm_copy': n}),
        ('probe_chw.lane_stride', ok_rc(probe_chw.lane_stride),
         {'lane_stride': n}),
        ('probe_chw.sub_stride', ok_rc(probe_chw.sub_stride),
         {'sub_stride': n}),
        ('probe_chw.strided_store', ok_rc(probe_chw.strided_store),
         {'strided_store': n}),
        ('probe_copy_bw.main', probe_copy_bw.main,
         {'permute_direct': (1 + len(probe_copy_bw.PORT_SHAPES)) * n,
          'permute_staged': (len(probe_copy_bw.N_TILES)
                             + len(probe_copy_bw.PORT_SHAPES)) * n}),
        ('probe_dma_align.main', probe_dma_align.main,
         {'dma_offset': len(probe_dma_align.CASES) * n,
          'value_slice': len(probe_dma_align.CASES) * n}),
    )
    launches = {}
    for label, entry, rows in runs:
        probes.reset_launches()
        rc = entry()
        got = dict(probes.LAUNCHES)
        want = dict.fromkeys(got, 0)
        for row, count in rows.items():
            want[PROBES[row][2]] += count
        print(f'probes: {label} rc {rc} launches {got}', flush=True)
        if rc != 0:
            raise AssertionError(f'probes: {label} failed its own checks')
        if got != want:
            raise AssertionError(f'probes: {label} launches {got}, expected '
                                 f'{want}')
        launches.update(rows)
    return launches


class ProbeCase:
    """One probe call: ``kernel`` and ``plain`` compute the same function;
    ``region`` picks what is compared (the written part of a copy);
    ``nbytes`` and ``ops`` are what the function must move and compute;
    ``library`` is the PyTorch call(s) computing it, or None; ``route``:
    (the wrapper, the route it must launch, as ``probes.ROUTES`` names
    it), or None."""

    def __init__(self, kernel, plain, library, nbytes, ops=0, region=None,
                 exact=True, route=None):
        self.kernel, self.plain, self.library = kernel, plain, library
        self.nbytes, self.ops, self.exact = nbytes, ops, exact
        self.region = region or (lambda out: out)
        self.route = route


def _probe_cases():
    """(probe row, label, make() -> ProbeCase), the JAX tool's largest
    shape of each row first."""
    import torch
    import torch.nn.functional as F
    from shiftnet_tpu_torch.ops import probes
    from shiftnet_tpu_torch.tools import (microbench, microbench_mm,
                                          probe_chw, probe_copy_bw,
                                          probe_dma_align)
    from shiftnet_tpu_torch.tools.timing import rand_bf16, randn_bf16

    cases = []
    mm_cases = microbench_mm.cases()  # the dense reference first
    for label, m, k, n, iters in mm_cases[:1] + [
            c for c in mm_cases if c[0].startswith(('P@W ', 'gate'))]:
        def mm(m=m, k=k, n=n, iters=iters):
            a, b = rand_bf16((m, k), 0), rand_bf16((k, n), 1)
            return ProbeCase(
                lambda: probes.mm_loop(a, b, iters),
                lambda: probes.mm_loop_plain(a, b, iters),
                lambda: [torch.matmul(a, b) for _ in range(iters)],
                2 * (m * k + k * n + m * n), 2 * m * k * n * iters,
                exact=False,
                route=('mm_loop', f'wgmma {MM_TILES[(m, k, n)]}'))
        cases.append(('mm_loop', f'{label} x{iters}', mm))

    def copy_case(x, out_shape, pieces, lanes, staged, library, tile=None,
                  **kw):
        nbytes = 2 * sum(p[4] for p in pieces) * lanes * x.element_size()
        if staged:
            route = ('block_copy_staged', 'tma')
        else:  # the direct copy's unit: 16 bytes unless a lane offset
            route = ('block_copy', 'element' if kw.get('src_lane', 0) % 8
                     else 'vector')
        if staged:
            def kernel():
                return probes.block_copy_staged(x, out_shape, pieces, lanes,
                                                tile=tile, **kw)
        else:
            def kernel():
                return probes.block_copy(x, out_shape, pieces, lanes, **kw)
        return ProbeCase(
            kernel,
            lambda: probes.block_copy_plain(x, out_shape, pieces, lanes,
                                            **kw),
            library, nbytes,
            region=lambda out: probes.written(out, pieces, lanes),
            route=route)

    def copy_x2(t=microbench.T, h=microbench.H, w=microbench.W,
                c=microbench.C):
        x = rand_bf16((t, h, w, c), 2)
        return copy_case(x.view(t, h, w * c), (1, h, w * c),
                         probes.slab_pieces(h, microbench.SLAB), w * c, True,
                         lambda: torch.mul(x[0], 2.0), scale=2.0)
    shape = (microbench.T, microbench.H, microbench.W, microbench.C)
    cases.append(('copy_x2_staged', f'2 * x[0], x {shape}, '
                  f'{microbench.SLAB}-row slabs', copy_x2))

    def hbm():
        x = randn_bf16((4, 128, 1024), 3)
        y = torch.empty_like(x)

        def lib():
            y[1:, 40:80].copy_(x[:-1, 40:80])
            y[0, 40:80].copy_(x[0, 40:80])
        return copy_case(x, x.shape, probes.hbm_copy_pieces(4, 40, 40), 1024,
                         False, lib)
    cases.append(('hbm_copy', '(4,128,1024) rows 40:80 from frame t-1',
                  hbm))

    c, m = probe_chw.C, probe_chw.M
    for row, mode, lib in (
            ('lane_stride', 'lane', lambda x: x[:, ::2].contiguous()),
            ('sub_stride', 'block',
             lambda x: x.view(x.shape[0], -1, 128)[:, ::2].reshape(
                 x.shape[0], -1)),
            ('strided_store', 'store',
             lambda a: F.pad(a[..., None], (0, 1)).flatten(1))):
        def strided(mode=mode, lib=lib, c=c, m=m):
            x = randn_bf16((c, m // 2 if mode == 'store' else m), 4)
            out_numel = m if mode == 'store' else m // 2
            read = x.numel() // 2 if mode == 'block' else x.numel()
            return ProbeCase(lambda: probes.strided_copy(x, mode),
                             lambda: probes.strided_copy_plain(x, mode),
                             lambda: lib(x), 2 * (read + c * out_numel))
        cases.append((row, f'({c},{m}) {mode}', strided))

    t, pp, cb, lp = probe_copy_bw.JAX_SHAPE
    shapes = [(f'JAX L1 ({t},{pp * cb},{lp}) pp {pp}', (t, pp * cb, lp),
               pp)] + [(f'port ({t},{ch},{hw}) pp 1', (t, ch, hw), 1)
                       for t, ch, hw in probe_copy_bw.PORT_SHAPES]
    for staged in (False, True):
        tiles = probe_copy_bw.N_TILES if staged else (None,)
        for i, (label, shape, pp) in enumerate(shapes):
            for n_tiles in (tiles if i == 0 else (None,)):
                def perm(shape=shape, pp=pp, staged=staged, n_tiles=n_tiles):
                    x = randn_bf16(shape, 5)
                    t, rows, lp = shape
                    half = rows // pp // 2
                    lanes, tile = lp, None
                    if n_tiles:
                        tile = lp // n_tiles
                        tile -= tile % 128
                        lanes = n_tiles * tile
                    y = torch.empty_like(x)
                    return copy_case(
                        x, shape, probes.shift_pieces(t, pp, rows // pp, half),
                        lanes, staged,
                        lambda: probe_copy_bw.copy_slices(x, y, pp, half,
                                                          lanes), tile=tile)
                cases.append(('permute_staged' if staged else 'permute_direct',
                              label + (f', {n_tiles} lane tiles' if n_tiles
                                       else ''), perm))

    for row, staged, rows in (('dma_offset', True, 48),
                              ('value_slice', False, 40)):
        for off, lane in probe_dma_align.CASES:
            def offset(staged=staged, rows=rows, off=off, lane=lane):
                x = randn_bf16((1, 128, 1024), 6)
                lanes = 1024 - 8 if lane else 1024
                y = x.new_empty((rows, lanes))
                return copy_case(
                    x, (1, rows, lanes), [(0, off, 0, 0, rows)], lanes,
                    staged,
                    lambda: y.copy_(x[0, off:off + rows, lane:lane + lanes]),
                    src_lane=lane)
            cases.append((row, f'(128,1024) rows {off}:{off + rows}'
                          + (f', lanes {lane}: ({2 * lane} B)' if lane
                             else ''), offset))
    return cases


def probe_phase(card):
    """The probe tools driven through their entry points, then each probe
    kernel against its plain version.  Returns ({probe row: record},
    {probe row: launches in the drive})."""
    import torch
    from shiftnet_tpu_torch.ops import probes
    from shiftnet_tpu_torch.tools.microbench_mm import MM_TOL, mm_err
    from shiftnet_tpu_torch.tools.timing import median_ms
    launches = _probe_drive()
    print(f'probes: copies bit for bit; mm_loop max|kernel - plain| / '
          f'max|plain| <= {MM_TOL:.2e} (one bf16 ulp)', flush=True)
    rec, failed = {}, []
    for name, label, make in _probe_cases():
        case = make()
        probes.ROUTES.clear()
        with torch.inference_mode():
            got, want = (case.region(case.kernel()),
                         case.region(case.plain()))
            torch.cuda.synchronize()
            abs_err = float((got.double() - want.double()).abs().max())
            if case.exact:
                ok, err = torch.equal(got, want), abs_err
            else:
                err = mm_err(got, want)
                ok = err <= MM_TOL
            del got, want
            route = ''
            if case.route:  # the route of the launch compared above
                took = probes.ROUTES.get(case.route[0])
                route = f' route {took}'
                ok &= took == case.route[1]
            ms = median_ms(case.kernel)
            pms = median_ms(case.plain)
            lms = None if case.library is None else median_ms(case.library)
        t_bytes = 1e3 * case.nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * case.ops / PEAK_OPS_PER_S['bfloat16']
        bound = max(t_bytes, t_ops)
        rate = (f'{case.ops / ms / 1e9:.1f} TF/s' if case.ops
                else f'{case.nbytes / ms / 1e6:.0f} GB/s')
        print(f'probe {name:14s} {label:44s} err {err:.3e} '
              f'{"ok" if ok else "FAIL"}{route}  kernel {ms:.4f} ms ({rate}, '
              f'{100 * bound / ms:.1f} % of bound)  plain {pms:.4f} ms  '
              f'library {"none" if lms is None else f"{lms:.4f} ms"}  bound '
              f'{bound:.4f} ms ({case.nbytes / 1e6:.2f} MB, '
              f'{case.ops / 1e9:.1f} GFLOP)  [{card}]', flush=True)
        if not ok:
            failed.append(f'{name} {label}')
        if name not in rec:  # the first case: the JAX tool's largest shape
            rec[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=pms,
                             library_ms=lms, bound_ms=bound,
                             bound_by='bytes' if t_bytes >= t_ops
                             else 'operations')
        rec[name]['max_abs_err'] = max(rec[name]['max_abs_err'], abs_err)
        del case
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f'probe kernels disagree with their plain '
                             f'versions: {failed}')
    return rec, launches


# The model kernels by their CUDA names, to find in a profiler trace.
MODEL_KERNEL_SYMBOLS = (*MMA_KERNELS, 'cab_back_kernel', 'shift_round_kernel')


def _write_videos(root, n_frames, h, w, seed):
    """Two synthetic videos of PNG frames under ``root/blur`` and
    ``root/gt`` (a noisy copy of each gt frame as its blurred frame)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for v in ('clip1', 'clip2'):
        base = rng.integers(0, 255, (h, w, 3))
        for sub in ('blur', 'gt'):
            os.makedirs(os.path.join(root, sub, v))
        for i in range(n_frames):
            gt = np.clip(base + rng.integers(-8, 8, (h, w, 3)), 0, 255)
            blur = np.clip(gt + rng.integers(-4, 4, (h, w, 3)), 0, 255)
            for sub, img in (('gt', gt), ('blur', blur)):
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(root, sub, v, f'{i:03d}.png'))


def _validation_cli(state, card, tmp):
    """``test_deblur.main`` with ``--grids``, NIQE and PSNR from the
    registry and ``--profile`` on two synthetic 6-frame videos; the
    Chrome trace must name a model kernel."""
    import contextlib
    import io
    from shiftnet_tpu_torch.tools import test_deblur
    data, prof = os.path.join(tmp, 'data'), os.path.join(tmp, 'prof')
    _write_videos(data, 6, *CLI_FRAME, seed=11)
    npz = os.path.join(tmp, 'net.npz')
    np.savez(npz, **{k: v.numpy() for k, v in state.items()})
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        test_deblur.main(['--model_path', npz, '--data_path', data,
                          '--result_path', os.path.join(tmp, 'out'),
                          '--one_len', '2', '--grids',
                          '--metric', 'niqe=calculate_niqe',
                          '--metric', 'psnr=calculate_psnr',
                          '--profile', prof])
    dt = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    with open(traces[0]) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    found = sorted({k for k in MODEL_KERNEL_SYMBOLS
                    if any(k in n for n in names)})
    total = [ln for ln in lines if ln.startswith('# Total')]
    print(f'validation: test_deblur --grids --metric niqe --metric psnr '
          f'--profile: {dt:.1f} s, {total[-1] if total else "no total"}; '
          f'trace {os.path.basename(traces[0])} '
          f'{os.path.getsize(traces[0]) / 1e6:.1f} MB names {found} '
          f'[{card}]', flush=True)
    if not total or 'AVG-NIQE=' not in total[-1] or not found:
        raise AssertionError('the profiled validation CLI run did not score '
                             'NIQE or its trace names no kernel of the port')


def validation_phase(card, logs, full_fps):
    """The validation protocol (``Evaluator.forward_grids``) on the
    kernels: equal to ``forward_window`` at a frame-covering crop; the
    float32 model on the kernels against the all-plain model at 8
    transforms; a timed 720p deblur_plus grids window with its launches
    and peak; every registry metric at 720p; the torch metrics against the
    numpy ones; the profiled CLI.  Returns the grids window's launches."""
    import torch
    from shiftnet_tpu_torch.eval import metrics
    from shiftnet_tpu_torch.eval.grids import plan_grids
    from shiftnet_tpu_torch.eval.registry import (METRIC_FUNCS,
                                                  calculate_metric)
    from shiftnet_tpu_torch.eval.runner import CONFIG_OVERRIDES, Evaluator
    from shiftnet_tpu_torch.models import build_model, init_state
    from shiftnet_tpu_torch.ops import chw

    state = init_state(build_model('deblur_plus'), seed=0)
    ev = Evaluator('deblur_plus', state, device='cuda', result_path=logs)
    sq = _clip(2 * HALO + 1, GRID_SQUARE, GRID_SQUARE, seed=12)
    same = np.array_equal(ev.forward_grids(sq, crop_size=GRID_SQUARE),
                          ev.forward_window(sq))
    print(f'validation: deblur_plus bf16 forward_grids at a frame-covering '
          f'crop ({GRID_SQUARE} of {sq.shape}) equals forward_window: '
          f'{same}', flush=True)
    if not same:
        raise AssertionError('forward_grids at a frame-covering crop differs '
                             'from forward_window')

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t, h, w, crop, trans = GRID_CHECK
    small = _clip(t, h, w, seed=13)
    outs = {}
    for name in ('fused_chw', 'plain'):
        e32 = Evaluator('deblur_plus', state, device='cuda', bf16=False,
                        overrides=CONFIG_OVERRIDES[name], result_path=logs)
        outs[name] = torch.from_numpy(e32.forward_grids(
            small, crop_size=crop, trans_num=trans))
        del e32
    err = _norm_err(outs['fused_chw'], outs['plain'])[0]
    print(f'validation: deblur_plus float32 forward_grids {t}x{h}x{w} crop '
          f'{crop} x {trans} transforms, kernels vs all-plain model: err '
          f'{err:.3e} (tol {SLICE_TOL_F32:.0e})', flush=True)
    if not err <= SLICE_TOL_F32:
        raise AssertionError('forward_grids on the kernels disagrees with '
                             'the plain model')
    del outs
    torch.cuda.empty_cache()

    clip = _clip(ONE_LEN + 2 * HALO, H, W, seed=1)
    n_crops = len(plan_grids(H, W, GRID_CROP))
    chw.reset_launches()
    out = ev.forward_grids(clip, crop_size=GRID_CROP)
    launches = dict(chw.LAUNCHES)
    expected = {k: n_crops * v for k, v in MAIN_PATH_LAUNCHES.items()}
    print(f'validation: deblur_plus grids window {clip.shape} {n_crops} '
          f'crops of {GRID_CROP}: launches {launches}', flush=True)
    if (launches != expected or out.shape != (ONE_LEN, H, W, 3)
            or not np.isfinite(out).all()):
        raise AssertionError(f'the grids window: launches {launches}, '
                             f'expected {expected}, or a bad output')
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev.forward_grids(clip, crop_size=GRID_CROP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f'validation: deblur_plus bf16 grids window T={clip.shape[0]} '
          f'{H}x{W}, {n_crops} crops of {GRID_CROP}, 1 transform: {dt:.3f} '
          f's/window, {ONE_LEN / dt:.4f} fps, peak {peak / 1e9:.3f} GB; the '
          f'full window in this call {full_fps:.4f} fps [{card}]', flush=True)
    del ev
    torch.cuda.empty_cache()

    img = np.clip(out[0], 0, 1) * 255.0
    gt = clip[HALO] * 255.0
    for name in METRIC_FUNCS:
        t0 = time.perf_counter()
        v = calculate_metric({'img': img, 'img2': gt}, {'type': name})
        ms = 1e3 * (time.perf_counter() - t0)
        print(f'validation: metric {name:15s} on one 720p frame: {v:.6f} in '
              f'{ms:.1f} host ms [{card}]', flush=True)
        if not np.isfinite(v):
            raise AssertionError(f'metric {name}: {v}')
    pair = (np.clip(out[:2], 0, 1) * 255.0, clip[HALO:HALO + 2] * 255.0)
    pt = metrics.psnr_t(*(torch.from_numpy(a).cuda() for a in pair)).cpu()
    st = metrics.ssim_t(*(torch.from_numpy(a).cuda() for a in pair)).cpu()
    dp = max(abs(float(pt[i]) - metrics.psnr(pair[0][i], pair[1][i]))
             for i in range(2))
    ds = max(abs(float(st[i]) - metrics.ssim(pair[0][i], pair[1][i]))
             for i in range(2))
    print(f'validation: psnr_t / ssim_t on the card vs numpy psnr / ssim, two '
          f'720p frames: |d| {dp:.2e} (tol 1e-3) / {ds:.2e} (tol 2e-4)',
          flush=True)
    if not (dp < 1e-3 and ds < 2e-4):
        raise AssertionError('psnr_t / ssim_t disagree with psnr / ssim')
    del out, pair, pt, st

    with tempfile.TemporaryDirectory() as tmp:
        _validation_cli(state, card, tmp)
    torch.cuda.empty_cache()
    return launches


def drift_phase(card):
    """``measure_drift`` on its default variants: bf16 on the kernels
    against float32 on the all-plain model; fails only on a non-finite
    output (``run`` raises)."""
    import torch
    from shiftnet_tpu_torch.models import CONFIGS
    from shiftnet_tpu_torch.tools import measure_drift
    for v in ('deblur_plus', 'denoise_small'):
        size = measure_drift.SIZES['denoise' if CONFIGS[v].noise_map
                                   else 'deblur']
        res = measure_drift.run(v, *size)
        print(f'drift: {v} {size}: {res["db"]:.2f} dB; peaks ' + ', '.join(
            f'{leg} {r["peak"] / 1e9:.3f} GB'
            for leg, r in res['legs'].items()) + f' [{card}]', flush=True)
        del res
        torch.cuda.empty_cache()


def bench_phase():
    """The port's bench entry point (``shiftnet_tpu_torch/tools/bench.py``)
    with one timed window: its JSON line must parse, with a finite fps."""
    import contextlib
    import io
    from shiftnet_tpu_torch.tools import bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(['--windows', '1'])
    line = buf.getvalue().strip().splitlines()[-1]
    print(f'bench: {line}', flush=True)
    rec = json.loads(line)
    if rc != 0 or not all(k in rec for k in ('metric', 'value', 'unit',
                                             'vs_baseline')):
        raise AssertionError(f'bench: rc {rc}, line {line}')
    if not (np.isfinite(rec['value']) and rec['value'] > 0):
        raise AssertionError(f'bench: fps {rec["value"]}')
    return rec


# Kernel launches of one fused deblur_plus train step: the forward
# (MAIN_PATH_LAUNCHES) and the checkpoint recompute of the 10 orbs
# (TFR_PATH_LAUNCHES) and of the 7 shift blocks' 28 round pairs (56 shift
# rounds, each CAB2 + CAB1 x 3 kernels); the backward runs the plain twins.
SHIFT_BLOCK_LAUNCHES = {'shift_round': 56, 'naf_gate': 112, 'naf_rep': 112,
                        'naf_back': 112}
TRAIN_FUSED_LAUNCHES = {
    k: MAIN_PATH_LAUNCHES[k] + TFR_PATH_LAUNCHES[k]
    + SHIFT_BLOCK_LAUNCHES.get(k, 0) for k in MAIN_PATH_LAUNCHES}
# The gradient check's clips (modest: full width and depth, small frames)
# and the published training shapes the CLI runs.
TRAIN_GRAD_CLIP = {'deblur_plus': (5, 64, 64), 'denoise_small': (4, 64, 64)}
TRAIN_STEPS = 4


def _train_grads(variant, state, batch, draws, fused,
                 dtype_name='float32'):
    """One port train step (lr 1e-3) of ``variant`` in ``dtype_name``: its
    gradients, loss and model (weights updated)."""
    import torch
    from shiftnet_tpu_torch.models import build_model
    from shiftnet_tpu_torch.train import optim
    from shiftnet_tpu_torch.train.step import TaskConfig, train_step
    dt = getattr(torch, dtype_name)
    model = build_model(variant, fused_chw=fused).cuda().to(dt)
    model.load_state_dict(state)
    cfg = model.cfg
    task = TaskConfig(kind='denoise' if cfg.noise_map else 'deblur',
                      center_slice=(cfg.past_frames, cfg.future_frames),
                      dtype=dt)
    opt = optim.build_optimizer(model, optim.OptimConfig(lr=1e-3))
    m = train_step(model, opt, task, {k: v.to(dt) for k, v in batch.items()},
                   None, draws=draws and tuple(v.to(dt) for v in draws))
    grads = {k: p.grad.double() for k, p in model.named_parameters()}
    return grads, float(m['loss']), model


def _grad_errs(a, b):
    """(relative L2 error of the whole gradient, max error over the RMS of
    the whole gradient, worst leaf's max error over its own RMS)."""
    d2 = sum(float((a[k] - b[k]).square().sum()) for k in b)
    n2 = sum(float(b[k].square().sum()) for k in b)
    n = sum(b[k].numel() for k in b)
    mx = max(float((a[k] - b[k]).abs().max()) for k in b)
    leaf = max(float((a[k] - b[k]).abs().max()
                     / b[k].square().mean().sqrt().clamp_min(1e-300))
               for k in b)
    return np.sqrt(d2 / n2), mx / np.sqrt(n2 / n), leaf


def _train_grad_check(variant, card):
    """f32 gradients on the kernels against the all-plain model, each also
    against the all-plain model in float64; and the fused forward after
    the step against the plain forward of the updated weights.

    The gradient tolerance is on the relative L2 error of the whole
    gradient.  A max error is no measure here: at full depth the plain
    float32 gradient is itself 1.5e-3 (deblur_plus) to 4.9e-3
    (denoise_small) of the gradient's RMS from the float64 one in its
    worst element (single PReLU / ReLU inputs within rounding of their
    kink), so the line prints it, beside float32's own, for information."""
    import torch
    from shiftnet_tpu_torch.models import build_model, init_state
    from shiftnet_tpu_torch.ops import chw
    from shiftnet_tpu_torch.train.step import TaskConfig, draw_noise
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = init_state(build_model(variant), seed=0)
    t, h, w = TRAIN_GRAD_CLIP[variant]
    rng = np.random.default_rng(21)
    gt = torch.from_numpy(rng.uniform(0, 1, (1, t, 3, h, w)).astype(
        np.float32)).cuda()
    batch, draws = {'gt': gt}, None
    if build_model(variant).cfg.noise_map:
        gen = torch.Generator(device='cuda').manual_seed(3)
        draws = draw_noise(gt, TaskConfig(kind='denoise'), gen)
    else:
        batch['lq'] = (gt + 0.05 * torch.randn_like(gt)).clamp(0, 1)
    chw.reset_launches()
    g_k, loss_k, fused = _train_grads(variant, state, batch, draws, True)
    launches = sum(chw.LAUNCHES.values())
    g_p, loss_p, _ = _train_grads(variant, state, batch, draws, False)
    g_64 = _train_grads(variant, state, batch, draws, False, 'float64')[0]
    err = _grad_errs(g_k, g_p)
    floor = _grad_errs(g_p, g_64)
    k64 = _grad_errs(g_k, g_64)
    # the fused forward after the step (no grad: the kernel ops, their
    # weight panels kept on the updated parameters) vs the plain forward
    x = (batch['lq'] if 'lq' in batch else gt + draws[1])[0]
    nm = None
    if draws is not None:
        nm = draws[0].view(1, 1, 1, 1).expand(t, 1, h, w)
    plain = build_model(variant).cuda()
    with torch.no_grad():
        plain.load_state_dict(state)
        before = plain(x, nm)
        plain.load_state_dict(fused.state_dict())
        chw.reset_launches()
        out_k = fused(x, nm)
        after_launches = sum(chw.LAUNCHES.values())
        out_p = plain(x, nm)
    step_err = _norm_err(out_k, out_p)[0]
    moved = _norm_err(out_k, before)[0]
    print(f'train: {variant} f32 {t}x{h}x{w} gradients on the kernels vs '
          f'all-plain: relative L2 {err[0]:.3e} (tol {SLICE_TOL_F32:.0e}), '
          f'max / RMS {err[1]:.3e}, worst leaf {err[2]:.3e}; against the '
          f'float64 plain: kernels {k64[0]:.3e} / {k64[1]:.3e} / '
          f'{k64[2]:.3e}, float32 plain {floor[0]:.3e} / {floor[1]:.3e} / '
          f'{floor[2]:.3e}; loss {loss_k:.6f} vs {loss_p:.6f}; {launches} '
          f'kernel launches; after one AdamW step: fused forward vs plain '
          f'forward of the updated weights err {step_err:.3e} (tol '
          f'{SLICE_TOL_F32:.0e}), vs the weights before the step '
          f'{moved:.3e}, {after_launches} launches [{card}]', flush=True)
    if not (err[0] <= SLICE_TOL_F32 and step_err <= SLICE_TOL_F32
            and moved > 10 * step_err and launches and after_launches):
        raise AssertionError(f'{variant}: training on the kernels disagrees '
                             'with the plain model')
    del g_k, g_p, g_64, fused, plain
    torch.cuda.empty_cache()
    return err


def _write_clip_folder(root, subs, n_frames, h, w, seed):
    """One synthetic video of PNG frames under each ``root/<sub>``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w, 3))
    for i in range(n_frames):
        img = np.clip(base + rng.integers(-12, 12, (h, w, 3)), 0, 255)
        for sub in subs:
            d = os.path.join(root, sub, 'clip1')
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, f'{i:03d}.png'))


def _train_cli(config, tmp, data, changes, card, label, count=False):
    """``tools/train.main(['-opt', <a copy of configs/<config> with
    changes>])`` with each step fenced by ``torch.cuda.synchronize()`` and
    timed; returns (trainer, step times, losses, peak, launches of the last
    step)."""
    import torch
    import yaml
    from shiftnet_tpu_torch.ops import chw
    from shiftnet_tpu_torch.tools import train as train_cli
    from shiftnet_tpu_torch.train import trainer as trainer_mod
    with open(os.path.join('configs', config)) as f:
        opt = yaml.safe_load(f)
    opt['datasets']['train']['dir_data'] = data
    opt['experiments_root'] = os.path.join(tmp, 'exp')
    opt['logger'] = dict(opt['logger'], print_freq=1)
    for k, v in changes.items():
        if k == 'total_iter':
            opt['train']['total_iter'] = v
        else:
            opt[k] = v
    path = os.path.join(tmp, f'{label}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f)
    times, losses, last = [], [], {}
    step = trainer_mod.train_step

    def timed(*args, **kw):
        torch.cuda.synchronize()
        chw.reset_launches()
        t0 = time.perf_counter()
        m = step(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        last.update(chw.LAUNCHES)
        losses.append(float(m['loss']))
        return m

    trainer_mod.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    try:
        tr = train_cli.main(['-opt', path])
    finally:
        trainer_mod.train_step = step
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:]) if len(times) > 1 else float('nan')
    print(f'train: {label}: {config} {tr.opt["model"]} T={opt["n_sequence"]} '
          f'patch {opt["patch_size"]} {tr.task.dtype} '
          f'{"fused" if tr.model.cfg.fused_chw else "plain"}, steps '
          f'{tr.step - len(times) + 1}..{tr.step}: '
          f'{med:.4f} s/step (median after the first; steps '
          f'{", ".join(f"{t:.4f}" for t in times)} s), peak '
          f'{peak / 1e9:.3f} GB, losses '
          f'{", ".join(f"{v:.5f}" for v in losses)} [{card}]', flush=True)
    if not (losses and all(np.isfinite(losses))):
        raise AssertionError(f'{label}: non-finite loss {losses}')
    return tr, times, losses, peak, dict(last) if count else None


def train_phase(card):
    """Single-GPU training: gradients and the post-step forward on the
    kernels against the plain model; the train CLI on the published
    gopro_deblur shape, unfused and fused, with a resume; two davis_denoise
    steps.  Returns the fused train step's launches."""
    for variant in TRAIN_GRAD_CLIP:
        _train_grad_check(variant, card)
    return _train_runs(card)


def _train_runs(card):
    """The train CLI runs of the train phase; returns the fused step's
    launches."""
    import torch
    torch.backends.cudnn.allow_tf32 = True  # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        gopro = os.path.join(tmp, 'gopro')
        _write_clip_folder(gopro, ('gt', 'blur'), 24, 288, 320, seed=31)
        runs = {}
        for label, fused in (('gopro_unfused', False),
                             ('gopro_fused', True)):
            runs[label] = _train_cli(
                'gopro_deblur.yml', tmp, gopro,
                {'total_iter': TRAIN_STEPS, 'fused': fused, 'name': label},
                card, label, count=fused)
            del runs[label][0].model, runs[label][0].optimizer
            torch.cuda.empty_cache()
        launches = runs['gopro_fused'][4]
        print(f'train: fused deblur_plus step launches {launches} '
              f'(expected {TRAIN_FUSED_LAUNCHES})', flush=True)
        if launches != TRAIN_FUSED_LAUNCHES:
            raise AssertionError('the fused train step did not run on the '
                                 'kernels as expected')
        tr = _train_cli('gopro_deblur.yml', tmp, gopro,
                        {'total_iter': TRAIN_STEPS + 2, 'fused': False,
                         'name': 'gopro_unfused'}, card, 'gopro_resume')[0]
        log = open(os.path.join(tmp, 'exp', 'gopro_unfused', 'train.log')
                   ).read()
        if ('auto-resumed from step 4' not in log
                or tr.step != TRAIN_STEPS + 2):
            raise AssertionError('the resumed run did not continue from '
                                 'step 4')
        print(f'train: gopro_resume: auto-resumed from step {TRAIN_STEPS}, '
              f'finished at step {tr.step}', flush=True)
        del tr
        torch.cuda.empty_cache()
        davis = os.path.join(tmp, 'davis')
        _write_clip_folder(davis, ('480p',), 16, 240, 256, seed=32)
        _train_cli('davis_denoise.yml', tmp, davis,
                   {'total_iter': 2, 'name': 'davis'}, card, 'davis')
    torch.cuda.empty_cache()
    return launches


def train_measure_phase(card):
    """The training measurement tools (``tools/bench_train.py``,
    ``tools/profile_train.py``) at the published shape: ``bench_train both
    23 256`` with one warm-up and 3 timed steps, then ``profile_train fused
    23 256``; prints the ``train_measure:`` lines."""
    from shiftnet_tpu_torch.tools import bench_train, profile_train
    bench = bench_train.main(['both', '23', '256', '--steps', '3',
                              '--warmup', '1'])
    prof = profile_train.main(['fused', '23', '256', '--iters', '1'])['fused']
    for form, r in bench.items():
        print(f'train_measure: bench_train {form} T=23 256: '
              f'{r["median_s"]:.4f} s/step (steps '
              f'{", ".join(f"{v:.4f}" for v in r["steps_s"])}; first '
              f'{r["first_s"][0]:.4f}), peak {r["peak"] / 1e9:.3f} GB; '
              f'{r["host_after"]} [{card}]', flush=True)
    tr = prof['trace']
    print(f'train_measure: profile_train fused T=23 256: forward '
          f'{prof["forward"]["s"]:.4f} s (peak '
          f'{prof["forward"]["peak"] / 1e9:.3f} GB), backward '
          f'{prof["backward_s"]:.4f} s, optimizer and loss glue '
          f'{prof["glue_s"]:.4f} s, step {prof["step"]["s"]:.4f} s (peak '
          f'{prof["step"]["peak"] / 1e9:.3f} GB); traced step: wall '
          f'{tr["wall_s"]:.3f} s, device busy {tr["busy_s"]:.3f} s '
          f'({100 * tr["busy_s"] / tr["wall_s"]:.1f} %), port kernels '
          f'{tr["port_s"]:.3f} of {tr["kernel_s"]:.3f} s kernel time; '
          f'{prof["step"]["host"]} [{card}]', flush=True)
    return bench, prof


# The parallel phase: 2 ranks (gloo on one card, NCCL with a card a rank).
PARALLEL_RANKS = 2
SP_GRAD_CLIP = (8, 64, 64)   # (c): f32 sequence-parallel gradients
TP_DN_T = 15                 # (b): shards of 8 and 7 frames
NCCL_ONE_RANK_T = 8          # (f): the one-rank NCCL step, depth cut


def _sub_windows(x, n, halo):
    """The single-process windows that ``temporal_parallel_forward`` runs
    on n ranks: each shard with ``halo`` frames of each neighbour, and at
    the ends the shard's own edge frames (``parallel/temporal.py``)."""
    from shiftnet_tpu_torch.parallel.temporal import shard_bounds
    t = x.shape[0]
    out = []
    for s, e in shard_bounds(t, n):
        left = x[s - halo:s] if s else x[:halo]
        right = x[e:e + halo] if e < t else x[t - halo:]
        out.append(np.concatenate([left, x[s:e], right]))
    return out


def _rel_l2(a, b):
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return float(np.sqrt(num / den))


def _max_abs(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in b)


def _write_parallel_config(tmp, src, name, data, changes):
    import yaml
    with open(os.path.join('configs', src)) as f:
        opt = yaml.safe_load(f)
    opt['datasets']['train']['dir_data'] = data
    opt['experiments_root'] = os.path.join(tmp, 'exp')
    opt['logger'] = dict(opt['logger'], print_freq=1)
    opt['name'] = name
    opt.update(changes)
    path = os.path.join(tmp, f'{name}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f)
    return path


def parallel_phase(card):
    """tp inference, sequence- and data-parallel training on 2 ranks
    (``parallel/launch.py``; gloo where they share this card), each held
    against the same work in one process; then one NCCL rank under
    torchrun against the single-process trainer.  Returns the per-rank
    launches of the tp window and of the fused sequence-parallel step."""
    import torch
    from shiftnet_tpu_torch.eval.runner import Evaluator
    from shiftnet_tpu_torch.models import build_model, init_state
    from shiftnet_tpu_torch.parallel import launch, workers
    from shiftnet_tpu_torch.parallel.mesh import choose_backend
    from shiftnet_tpu_torch.train.step import TaskConfig, draw_noise
    n = PARALLEL_RANKS
    backend = choose_backend(torch.device('cuda'), n)
    print(f'parallel: {n} ranks on {torch.cuda.device_count()} GPU(s), '
          f'backend {backend} [{card}]', flush=True)
    deblur = init_state(build_model('deblur_plus'), seed=0)
    denoise = init_state(build_model('denoise_plus'), seed=0)
    x_db = _clip(ONE_LEN + 2 * HALO, H, W, seed=1)
    x_dn = _clip(TP_DN_T, DN_H, DN_W, seed=41)
    t, h, w = SP_GRAD_CLIP
    rng = np.random.default_rng(42)
    gt = torch.from_numpy(rng.uniform(0, 1, (1, t, 3, h, w)).astype(
        np.float32))
    sp_batch = {'gt': gt, 'lq': (gt + 0.05 * torch.from_numpy(
        rng.standard_normal(gt.shape).astype(np.float32))).clamp(0, 1)}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, 'gopro')
        for seed, clip in ((51, 'clip1'), (52, 'clip2')):
            _write_clip_folder(os.path.join(tmp, clip), ('gt', 'blur'), 24,
                               288, 320, seed=seed)
            for sub in ('gt', 'blur'):
                os.makedirs(os.path.join(data, sub), exist_ok=True)
                os.rename(os.path.join(tmp, clip, sub, 'clip1'),
                          os.path.join(data, sub, clip))
        sp = {fused: _write_parallel_config(
            tmp, 'gopro_deblur_tp8.yml', f'sp_{int(fused)}', data,
            {'time_parallel': n, 'fused': fused,
             'train': _total_iter('gopro_deblur_tp8.yml', 3)})
            for fused in (False, True)}
        dp = _write_parallel_config(
            tmp, 'gopro_deblur_dp8.yml', 'dp', data,
            {'train': _total_iter('gopro_deblur_dp8.yml', 1)})
        jobs = [
            ('collectives', (), {}),
            ('evaluator_windows', ('deblur_plus', deblur, [(x_db, None)]),
             {}),
            ('evaluator_windows', ('denoise_plus', denoise,
                                   [(x_dn, SIGMA)]), {}),
            ('train_steps', ('deblur_plus', {}, deblur, sp_batch, None),
             dict(data=1, time_=n, fused=True)),
            ('train_cli', (sp[False], [3], 'cuda'), {}),
            ('train_cli', (sp[True], [3], 'cuda'), {}),
            ('train_cli', (dp, [1], 'cuda'), {})]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.run(workers.run_jobs, n, jobs, device='cuda',
                           threads=4, timeout=900)
        print(f'parallel: the ranks took {time.perf_counter() - t0:.1f} s',
              flush=True)
        probe, *res = [list(r) for r in zip(*ranks)]  # by job, then rank
        print(f'parallel: {probe[0]["backend"]} with CUDA tensors: '
              + '; '.join(f'{k} {v}' for k, v in probe[0]['ops'].items()),
              flush=True)
        launches = {'tp_deblur_plus': _tp_check(
            'deblur_plus', deblur, x_db, None, res[0], MAIN_PATH_LAUNCHES,
            card, tmp)}
        _tp_check('denoise_plus', denoise, x_dn, SIGMA, res[1],
                  DENOISE_LAUNCHES, card, tmp)
        del x_db, x_dn
        one = workers.train_steps('deblur_plus', {}, deblur, sp_batch, None,
                                  data=1, time_=1, fused=True)
        err = _rel_l2(res[2][0]['grads'], one['grads'])
        mx = _max_abs(res[2][0]['grads'], one['grads'])
        print(f'parallel: (c) sequence-parallel deblur_plus f32 fused '
              f'{t}x{h}x{w} on {n} ranks vs one process: gradients relative '
              f'L2 {err:.3e} (tol 1e-5), max abs {mx:.3e}; loss '
              f'{res[2][0]["loss"]:.7f} vs {one["loss"]:.7f}; grad norm '
              f'{res[2][0]["grad_norm"]:.6e} vs {one["grad_norm"]:.6e} '
              f'[{card}]', flush=True)
        if not err <= 1e-5:
            raise AssertionError('sequence-parallel gradients disagree')
        launches['train_sp_fused'] = _sp_cli_check(res[3], res[4], card)
        _dp_check(res[5], dp, tmp, card)
        _nccl_one_rank_check(tmp, data, card)
    torch.cuda.empty_cache()
    return launches


def _total_iter(config, n):
    import yaml
    with open(os.path.join('configs', config)) as f:
        train = yaml.safe_load(f)['train']
    return dict(train, total_iter=n)


def _tp_check(variant, state, x, sigma, res, expected, card, tmp):
    """(a), (b): rank 0's gathered tp window against the single-process
    forward of the sub-windows, bit for bit; each rank's launches and
    peak."""
    import torch
    from shiftnet_tpu_torch.eval.runner import Evaluator
    ev = Evaluator(variant, state, device='cuda', result_path=tmp)
    outs = [ev.forward_window(w, sigma) for w in
            _sub_windows(x, PARALLEL_RANKS, HALO)]
    want = np.concatenate(outs)[HALO:x.shape[0] - HALO]
    del ev, outs
    torch.cuda.empty_cache()
    got = res[0]['outs'][0].numpy()
    same = got.shape == want.shape and np.array_equal(got, want)
    gap = (float(np.abs(got - want).max()) if got.shape == want.shape
           else 'shape')
    launches = [r['launches'][0] for r in res]
    print(f'parallel: tp {variant} {x.shape[0]}x{x.shape[1]}x{x.shape[2]} '
          f'{"f32" if sigma else "bf16"} on {PARALLEL_RANKS} ranks: '
          f'{got.shape[0]} gathered frames equal the single-process '
          f'sub-windows bit for bit: {same} (max abs '
          f'{gap}); '
          f'seconds {[round(r["seconds"][0], 3) for r in res]}, peaks '
          f'{[round(r["peaks"][0] / 1e9, 3) for r in res]} GB; grids and '
          f'quadrant raise: {[len(r["raised"]) for r in res]}; launches per '
          f'rank {launches} [{card}]', flush=True)
    log = res[0]['log']
    print('\n'.join(f'parallel:   {line}' for line in log.splitlines()
                    if line.startswith(('[tp]', '[plan]'))), flush=True)
    if not same or any(len(r['raised']) != 2 for r in res):
        raise AssertionError(f'tp {variant}: the gathered window differs')
    if any(k != expected for k in launches):
        raise AssertionError(f'tp {variant}: launches {launches}, expected '
                             f'{expected} a rank')
    return {k: [lc[k] for lc in launches] for k in expected}


def _sp_cli_check(unfused, fused, card):
    """(d): the train CLI on a copy of gopro_deblur_tp8.yml with
    time_parallel 2; returns the fused step's launches a rank."""
    for label, res in (('unfused', unfused), ('fused', fused)):
        run = [r['runs'][-1] for r in res]
        med = statistics.median(run[0]['seconds'][1:])
        print(f'parallel: (d) train CLI gopro_deblur_tp8.yml time_parallel '
              f'{PARALLEL_RANKS} (T=24 patch 256, {label}), mesh '
              f'{run[0]["mesh"]}: s/step {med:.4f} '
              f'(steps {", ".join(f"{v:.4f}" for v in run[0]["seconds"])}; '
              f'ranks share one card: not a speedup), losses '
              f'{", ".join(f"{v:.5f}" for v in run[0]["losses"])}, peaks '
              f'{[round(r["peak"] / 1e9, 3) for r in res]} GB, backend '
              f'{res[0]["backend"]} [{card}]', flush=True)
        if not (all(np.isfinite(run[0]['losses'])) and run[0]['step'] == 3
                and [r['primary'] for r in run] == [True, False]):
            raise AssertionError(f'sequence-parallel CLI {label} failed')
        if any(r['runs'][-1]['losses'] != run[0]['losses'] for r in res):
            raise AssertionError('the ranks report different losses')
    launches = [r['runs'][-1]['launches'] for r in fused]
    print(f'parallel: (d) fused step launches a rank {launches} (expected '
          f'{TRAIN_FUSED_LAUNCHES})', flush=True)
    if any(lc != TRAIN_FUSED_LAUNCHES for lc in launches):
        raise AssertionError('the fused sequence-parallel step did not run '
                             'on the kernels as expected')
    return {k: [lc[k] for lc in launches] for k in TRAIN_FUSED_LAUNCHES}


def _single_cli(path, changes, tmp, label):
    """The train CLI in this process (no process group) on a copy of the
    config at ``path`` with ``changes``; returns its final weights and its
    last step's metrics."""
    import yaml
    from shiftnet_tpu_torch.tools import train as train_cli
    with open(path) as f:
        opt = yaml.safe_load(f)
    opt.update(changes, name=label)
    p = os.path.join(tmp, f'{label}.yml')
    with open(p, 'w') as f:
        yaml.safe_dump(opt, f)
    tr = train_cli.main(['-opt', p])
    return ({k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
            {k: float(v) for k, v in tr.metrics.items()})


def _dp_check(res, path, tmp, card):
    """(e): gopro_deblur_dp8.yml on 2 ranks for one step against one
    process with batch 2 on the same two clips: the updated parameters to
    1e-5 relative L2, the loss and the global gradient norm to 1e-5.  The
    update itself (new - old weights) is printed, not held: AdamW's first
    step is g / (|g| + 1e-8) a weight, so where |g| is near 1e-8 the
    summation order of the gradients moves it by a large fraction."""
    import torch
    from shiftnet_tpu_torch.models import build_model, init_state
    one, m1 = _single_cli(path, {'batch_size_per_device': PARALLEL_RANKS},
                          tmp, 'dp_single')
    start = init_state(build_model('deblur_plus'), seed=0)
    par = res[0]['params']
    run = res[0]['runs'][0]
    upd = {k: par[k] - start[k] for k in start}
    ref = {k: one[k] - start[k] for k in start}
    err, uerr = _rel_l2(par, one), _rel_l2(upd, ref)
    loss, gn = run['losses'][0], run['grad_norms'][0]
    same = all(torch.equal(r['params'][k], par[k]) for r in res for k in par)
    print(f'parallel: (e) gopro_deblur_dp8.yml on {PARALLEL_RANKS} ranks, one '
          f'step, vs one process at batch {PARALLEL_RANKS}: parameters '
          f'relative L2 {err:.3e} (tol 1e-5), the update {uerr:.3e}; loss '
          f'{loss:.7f} vs {m1["loss"]:.7f}, grad norm {gn:.6e} vs '
          f'{m1["grad_norm"]:.6e}; ranks equal {same}; mesh {run["mesh"]}, '
          f'peaks {[round(r["peak"] / 1e9, 3) for r in res]} GB [{card}]',
          flush=True)
    if not (err <= 1e-5 and same and abs(loss - m1['loss']) <= 1e-5 * loss
            and abs(gn - m1['grad_norm']) <= 1e-5 * gn):
        raise AssertionError('the data-parallel step differs from the '
                             'single-process one')


def _nccl_one_rank_check(tmp, data, card):
    """(f): the train CLI under torchrun with one rank on NCCL against the
    same config in one process (the single-GPU trainer), at T =
    ``NCCL_ONE_RANK_T``.  The first step's loss (the forward, before any
    update) must be equal bit for bit, and so must the updated weights,
    unless a second single-process run differs from the first too (the
    backward of the plain bilinear upsample and of cuDNN's weight
    gradients add with atomics, in no fixed order; PR 14 saw one such
    call): then within 1e-5 relative L2, and the line prints both
    differences."""
    import torch
    from shiftnet_tpu_torch.train.checkpoint import load_params_npz
    path = _write_parallel_config(
        tmp, 'gopro_deblur.yml', 'nccl1', data,
        {'train': _total_iter('gopro_deblur.yml', 1),
         'n_sequence': NCCL_ONE_RANK_T})
    one, m1 = _single_cli(path, {}, tmp, 'nccl1_single')
    script = os.path.join(tmp, 'train_one_rank.py')
    with open(script, 'w') as f:  # the train CLI, and its last loss exactly
        f.write('import sys\nfrom shiftnet_tpu_torch.tools import train\n'
                'tr = train.main(sys.argv[1:])\n'
                "print('last loss', repr(float(tr.metrics['loss'])))\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '1', script, '-opt', path],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, 'PYTHONPATH': os.getcwd()})
    out = proc.stdout + proc.stderr
    if proc.returncode:
        raise AssertionError(f'torchrun train failed:\n{out[-4000:]}')
    got = load_params_npz(os.path.join(tmp, 'exp', 'nccl1', 'models',
                                       'net_g_1.npz'))
    one = {k: v.float() for k, v in one.items()}
    same = all(torch.equal(got[k], one[k]) for k in one)
    again, m2 = (one, m1) if same else _single_cli(path, {}, tmp,
                                                   'nccl1_again')
    again = {k: v.float() for k, v in again.items()}
    reproducible = all(torch.equal(again[k], one[k]) for k in one)
    loss = re.search(r'last loss (\S+)', out)
    loss = float(loss.group(1)) if loss else None
    backend = re.search(r'backend (\w+)', out)
    err, spread = _rel_l2(got, one), _rel_l2(again, one)
    print(f'parallel: (f) torchrun one rank, backend '
          f'{backend.group(1) if backend else "?"}, gopro_deblur.yml (T = '
          f'{NCCL_ONE_RANK_T}) one step vs one process: loss {loss!r} vs '
          f'{m1["loss"]!r}; weights equal bit for bit: {same} (relative L2 '
          f'{err:.3e})'
          + ('' if same else f'; a second single-process run: loss '
             f'{m2["loss"]!r}, weights equal bit for bit: {reproducible} '
             f'(relative L2 {spread:.3e})')
          + f' ({time.perf_counter() - t0:.1f} s) [{card}]', flush=True)
    if not backend or backend.group(1) != 'nccl':
        raise AssertionError('the one-rank run was not on NCCL')
    if not (loss == m1['loss'] == m2['loss']
            and (same or (not reproducible and err <= 1e-5))):
        raise AssertionError('the one-rank NCCL step differs')

def main():
    card = device_phase()
    build_phase()
    import torch
    rec = kernel_phase(card)
    t0 = time.perf_counter()
    probe_rec, probe_launches = probe_phase(card)
    print(f'probes: phase took {time.perf_counter() - t0:.1f} s', flush=True)
    with tempfile.TemporaryDirectory() as logs:
        launches, full_fps = deblur_phase(card, logs)
        launches.update(denoise_phase(card, logs))
        launches.update(small_phase(card, logs))
        t0 = time.perf_counter()
        launches['deblur_plus_grids'] = validation_phase(card, logs,
                                                         full_fps)
        print(f'validation: phase took {time.perf_counter() - t0:.1f} s',
              flush=True)
    t0 = time.perf_counter()
    drift_phase(card)
    print(f'drift: phase took {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    bench_phase()
    print(f'bench: phase took {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    launches['train_deblur_plus_fused'] = train_phase(card)
    print(f'train: phase took {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    train_measure_phase(card)
    print(f'train_measure: phase took {time.perf_counter() - t0:.1f} s',
          flush=True)
    t0 = time.perf_counter()
    launches.update(parallel_phase(card))
    print(f'parallel: phase took {time.perf_counter() - t0:.1f} s',
          flush=True)
    kernels = []
    for name, (src, repl, also, counter, main_path) in KERNELS.items():
        r = rec[name]
        # ``launches``: the main path that carries the kernel (the default
        # deblur_plus window for most, the conv_concat window for conv_cat,
        # the deblur_small window for the depthwise naf_rep); the
        # ``launches_<path>`` keys give every driven path.
        entry = {'name': name, 'route': 'cuda', 'source': src,
                 'replaces': repl,
                 'launches': launches[main_path][counter],
                 **{f'launches_{path}': _form_launches(name, path, n[counter])
                    for path, n in launches.items()},
                 'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                 'bound_by': r['bound_by'], 'library_ms': r['library_ms']}
        if also:
            entry['also_replaces'] = also
        kernels.append(entry)
    for name, (src, repl, counter) in PROBES.items():
        r = probe_rec[name]
        # ``launches``: the probes phase's drive of the tools, the path
        # that carries the probe kernels; ``kernel``: the CUDA kernel (and
        # launch counter) that runs this TPU kernel.
        kernels.append({'name': name, 'route': 'cuda',
                        'source': f'shiftnet_tpu_torch/csrc/{src}',
                        'replaces': repl, 'kernel': counter,
                        'launches': probe_launches[name],
                        'launches_probes': probe_launches[name],
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
