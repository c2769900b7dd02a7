"""The plain-CAB, conv, concat-conv and SkipUpSample CUDA kernels, their
plain versions, and the TFR U-Net composed from them.

Counterpart of ``shiftnet_tpu/ops/chw.py``.  The JAX module runs these ops
on a packed ``ChwTensor`` layout that exists for the TPU's tiling rules; here
every op takes logical ``(T, C, H, W)`` tensors, contiguous.

Dispatch, the same for every public op:

- a CUDA tensor launches the kernel (``csrc/*.cu``, built by ``_build``),
  or raises;
- a CPU tensor runs the op's plain PyTorch version (``*_plain``);
- any other device raises.

``LAUNCHES`` counts kernel launches per op, this module's five and the
shift-block kernels of ``ops/naf_chw``, so a run can show that it went
through the kernels.  Conv weights come as the float32 parameters (or in
the activation type): each kernel rounds them to the activation type, as
flax's ``dtype=`` does, and keeps their packed panels on the parameter
(``tap_panel``, ``cat_panel``); PReLU slopes and biases stay float32, and
the kernels apply them in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from shiftnet_tpu_torch.ops import _build
from shiftnet_tpu_torch.ops.resize import bilinear_up2x

LAUNCHES = {'cab_front': 0, 'cab_back': 0, 'conv': 0, 'up_skip': 0,
            'shift_round': 0, 'naf_gate': 0, 'naf_rep': 0, 'naf_back': 0,
            'conv_cat': 0}

# Shared memory a block may use on Hopper (227 KB).
SMEM_BYTES = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == 'cuda':
        return True
    if x.device.type == 'cpu':
        return False
    raise ValueError(f'no kernel or plain version for device {x.device}')


def _check(name: str, x: torch.Tensor, *same_type: torch.Tensor | None,
           f32: tuple[torch.Tensor | None, ...] = ()) -> int:
    """Validate what a kernel takes; returns its dtype code."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f'{name}: dtype {x.dtype} not supported')
    for t in (x, *same_type, *f32):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f'{name}: tensors on {t.device} and {x.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
    for t in same_type:
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f'{name}: {t.dtype} operand with {x.dtype} input')
    for t in f32:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f'{name}: weights, biases and PReLU slopes '
                            f'must be float32')
    return _DTYPE_CODE[x.dtype]


def check_inplace(name: str, x: torch.Tensor, inplace: bool) -> None:
    """A kernel writes through a raw pointer, which bumps no version
    counter: an in-place write over a tensor autograd may have saved would
    give silently wrong gradients.  So no op writes in place over a tensor
    that requires grad."""
    if inplace and x.requires_grad:
        raise RuntimeError(f'{name}: in-place write over a tensor that '
                           'requires grad')


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return F.prelu(x, alpha.to(x.dtype))


# -- the tensor-core conv layout (csrc/conv_core.cuh) -------------------------

# Shared memory of the SM (228 KB) and what the card reserves per block: a
# block of at most TWO_PER_SM bytes lets two blocks share an SM.
SM_SMEM_BYTES = 233472
TWO_PER_SM = SM_SMEM_BYTES // 2 - 1024
# A conv's weight panels are kept whole in shared memory up to this size,
# else streamed one tap at a time, double-buffered (kResidentBytes).
RESIDENT_BYTES = 40960


def pad_chunk(c: int, itemsize: int) -> int:
    """Channels rounded up to a 16-byte chunk: 8 in bfloat16, 4 in
    float32."""
    ch = 16 // itemsize
    return -(-c // ch) * ch


def mma_pitch(c: int, itemsize: int) -> int:
    """Row length (elements) of a pixel-major tile or a weight panel row
    with c channels: ``pad_chunk``, plus a chunk where that is an even
    number of 16-byte units, so the 8 rows of one ldmatrix fall in distinct
    bank groups (``mma_pitch`` in conv_core.cuh)."""
    p = pad_chunk(c, itemsize)
    return p if (p * itemsize // 16) % 2 else p + 16 // itemsize


# Output rows of the naf_gate / naf_rep expands n -> 2n (n = 32, 48, 64,
# 80): two warp columns of an even number of n8 tiles (dispatch_np's
# kExpand table).
EXPAND_NP = (64, 96, 128, 160)


def mma_layout(c_in: int, c_out: int, itemsize: int, *,
               expand: bool = False) -> tuple[int, int]:
    """(Np, KP) of the packed weights of a c_in -> c_out conv: output
    channel rows padded to whole n8 tiles on one warp column (up to 7
    tiles) or on two, and the panel row length (``dispatch_np``).
    ``expand``: the layout of a naf expand, c_out = 2n in ``EXPAND_NP``."""
    if expand:
        if c_out not in EXPAND_NP:
            raise ValueError(f'expand: 2n={c_out} not in {EXPAND_NP}')
        return c_out, mma_pitch(c_in, itemsize)
    nt = -(-c_out // 8)
    np_ = 8 * nt if nt <= 7 else 16 * -(-nt // 2)
    if np_ > 112:
        raise ValueError(f'conv: Cout={c_out} exceeds the 112 channels of '
                         'the tensor-core form')
    return np_, mma_pitch(c_in, itemsize)


def pack_taps(w: torch.Tensor, np_: int, kp: int) -> torch.Tensor:
    """(Cout, Cin, K, K) -> (K*K, np_, kp): one panel per tap (ky * K + kx),
    output channels on the rows, input channels along them, zero-padded;
    the B operand of the tensor-core convs, in w's type."""
    c_out, c_in, k, _ = w.shape
    wt = w.permute(2, 3, 0, 1).reshape(k * k, c_out, c_in)
    return F.pad(wt, (0, kp - c_in, 0, np_ - c_out)).contiguous()


def _kept_panel(w: torch.Tensor, dtype: torch.dtype, attr: str,
                pack) -> torch.Tensor:
    """``pack`` of w rounded to ``dtype``, packed once per weight: the
    result is kept on w (attribute ``attr``) and reused while w's storage,
    version, type and device and ``dtype`` stay the same (an in-place write
    such as ``load_state_dict`` bumps the version).  An inference tensor,
    whose version is not tracked, is packed anew at every call."""
    if w.is_inference():
        return pack(w.to(dtype))
    key = (w.data_ptr(), w._version, w.dtype, w.device, dtype)
    hit = getattr(w, attr, None)
    if hit is None or hit[0] != key:
        hit = (key, pack(w.detach().to(dtype)))
        setattr(w, attr, hit)
    return hit[1]


def tap_panel(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tensor-core panels of a conv weight (Cout, Cin, K, K): (K*K, Np,
    KP) in ``dtype`` (``pack_taps`` at ``mma_layout``), the weight rounded
    to dtype, packed once per weight (``_kept_panel``)."""
    c_out, c_in = w.shape[:2]
    layout = mma_layout(c_in, c_out, torch.empty((), dtype=dtype
                                                 ).element_size())
    return _kept_panel(w, dtype, '_tap_panel',
                       lambda v: pack_taps(v, *layout))


def cm_pitch(m: int) -> int:
    """Row length (elements) of a channel-major tile of m pixels (naf_back,
    up_skip): m rounded up to 16 plus 8 (``cm_pitch`` in conv_core.cuh)."""
    return -(-m // 16) * 16 + 8


def mma_weight_smem(taps: int, np_: int, kp: int, itemsize: int) -> int:
    """Shared memory of a conv's panels: whole (always for one tap), or
    two streamed taps."""
    whole = taps * np_ * kp * itemsize
    return (whole if taps == 1 or whole <= RESIDENT_BYTES
            else 2 * np_ * kp * itemsize)


def _pick_tile(tiles, smem, itemsize: int) -> tuple[int, int]:
    """bfloat16: the first tile that lets two blocks share an SM (its
    kernels take at most 128 registers a thread), else the first that fits
    one block; float32 (3xTF32's split fragments take more than 128
    registers a thread at the wide widths): the first that fits."""
    for limit in ((TWO_PER_SM, SMEM_BYTES) if itemsize == 2
                  else (SMEM_BYTES,)):
        for tile in tiles:
            if smem(*tile) <= limit:
                return tile
    raise ValueError('no tile fits in shared memory')


# -- A: cab_front ------------------------------------------------------------

# Every output tile cab_front takes, in bfloat16's order of preference;
# float32 prefers them in _CAB_F32 order (tools/bench_conv.py --tiles
# measures both).
CAB_TILES = ((16, 32), (16, 16), (8, 32), (8, 16))
_CAB_F32 = ((8, 32), (8, 16), (16, 16))


def cab_front_smem(c: int, itemsize: int, th: int, tw: int) -> int:
    """Shared memory of one ``cab_front`` block (csrc/cab_front.cu): the
    pixel-major input tile with a 2-pixel halo and intermediate with a
    1-pixel halo, at ``mma_pitch(c)``, and the weight panels."""
    tiles = (th + 4) * (tw + 4) + (th + 2) * (tw + 2)
    return (tiles * mma_pitch(c, itemsize) * itemsize
            + mma_weight_smem(9, *mma_layout(c, c, itemsize), itemsize))


def cab_front_tile(c: int, itemsize: int) -> tuple[int, int]:
    """Output tile (TH, TW) of ``cab_front`` (``_pick_tile``)."""
    return _pick_tile(CAB_TILES if itemsize == 2 else _CAB_F32,
                      lambda th, tw: cab_front_smem(c, itemsize, th, tw),
                      itemsize)


def cab_front_plain(x, w1, alpha, w2):
    s = F.conv2d(prelu(F.conv2d(x, w1, padding=1), alpha), w2, padding=1)
    return s, s.float().sum(dim=(2, 3))


def cab_front(x: torch.Tensor, w1: torch.Tensor, alpha: torch.Tensor,
              w2: torch.Tensor, *, tile: tuple[int, int] | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """CAB body conv3x3 -> PReLU -> conv3x3 (bias-free).

    x: (T, C, H, W); w1, w2: (C, C, 3, 3) in x's type or float32 (the
    parameters themselves, rounded to x's type; the kernel reads their
    panels, ``tap_panel``, packed once); alpha: (1,) float32.  ``tile``:
    the kernel's output tile, else ``cab_front_tile``'s.
    Returns s (T, C, H, W) and its float32 channel sums (T, C).
    """
    if not _on_cuda(x):
        return cab_front_plain(x, w1.to(x.dtype), alpha, w2.to(x.dtype))
    same, f32 = ((w1, w2), ()) if w1.dtype == x.dtype else ((), (w1, w2))
    code = _check('cab_front', x, *same, f32=(alpha, *f32))
    t, c, h, w = x.shape
    if w1.shape != (c, c, 3, 3) or w2.shape != (c, c, 3, 3):
        raise ValueError(f'cab_front: weights {w1.shape} {w2.shape} for C={c}')
    size = x.element_size()
    th, tw = tile or cab_front_tile(c, size)
    if cab_front_smem(c, size, th, tw) > SMEM_BYTES or tw % 8:
        raise ValueError(f'cab_front: tile {th}x{tw} at C={c}: not a tile '
                         'the kernel takes')
    n_blocks = -(-h // th) * -(-w // tw)
    w1t, w2t = tap_panel(w1, x.dtype), tap_panel(w2, x.dtype)
    np_, kp = w1t.shape[1:]
    s = torch.empty_like(x)
    part = torch.empty((t, n_blocks, c), device=x.device, dtype=torch.float32)
    lib = _build.library()
    _build.check(lib.shiftnet_cab_front(
        code, x.data_ptr(), w1t.data_ptr(), alpha.data_ptr(), w2t.data_ptr(),
        s.data_ptr(), part.data_ptr(), t, c, np_, kp, h, w, th, tw,
        _stream()), 'cab_front')
    LAUNCHES['cab_front'] += 1
    return s, part.sum(dim=1)


def ca_mlp(sums: torch.Tensor, n_px: int, du1: torch.Tensor,
           du2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """CALayer weights (T, C) from float32 channel sums: mean in float32,
    cast to the compute type, then 1x1 -> ReLU -> 1x1 -> sigmoid
    (``shiftnet_tpu/ops/chw.py:ca_mlp``).  du1: (C/r, C, 1, 1); du2:
    (C, C/r, 1, 1)."""
    mean = (sums / n_px).to(dtype)
    z = torch.relu(mean @ du1.flatten(1).t().to(dtype))
    return torch.sigmoid(z @ du2.flatten(1).t().to(dtype))


# -- B: cab_back -------------------------------------------------------------

def cab_back_plain(x, s, ca, inplace=False):
    scaled = s * ca[:, :, None, None]
    return x.add_(scaled) if inplace else x + scaled


def cab_back_route(x: torch.Tensor, s: torch.Tensor,
                   out: torch.Tensor) -> str:
    """``'vector'`` where csrc/cab_back.cu can move 16-byte units (a plane
    of x a whole number of them, x, s and out 16-byte aligned), else
    ``'element'``."""
    plane = x.shape[2] * x.shape[3] * x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, s, out))
    return 'vector' if plane % 16 == 0 and aligned else 'element'


def cab_back(x: torch.Tensor, s: torch.Tensor, ca: torch.Tensor, *,
             inplace: bool = False) -> torch.Tensor:
    """out = x + s * ca[t, c], the product rounded to x's type before the
    add.  ``inplace`` writes over x: only for callers that know x is dead
    afterwards.  The kernel's route, 16-byte units or single elements, is
    ``cab_back_route``'s."""
    check_inplace('cab_back', x, inplace)
    if not _on_cuda(x):
        return cab_back_plain(x, s, ca, inplace)
    code = _check('cab_back', x, s, ca)
    t, c, h, w = x.shape
    if s.shape != x.shape or ca.shape != (t, c):
        raise ValueError(f'cab_back: s {s.shape}, ca {ca.shape}, x {x.shape}')
    out = x if inplace else torch.empty_like(x)
    vector = cab_back_route(x, s, out) == 'vector'
    lib = _build.library()
    _build.check(lib.shiftnet_cab_back(
        code, x.data_ptr(), s.data_ptr(), ca.data_ptr(), out.data_ptr(),
        t * c, h * w, int(vector), _stream()), 'cab_back')
    LAUNCHES['cab_back'] += 1
    return out


# -- C: conv -----------------------------------------------------------------

def conv_pad(k: int, stride: int) -> int:
    """Padding of ``conv`` (``shiftnet_tpu/ops/chw.py:conv_chw``)."""
    return k // 2 if stride == 1 else (1 if k == 3 else 0)


def conv_plain(x, w, bias, alpha, stride):
    y = F.conv2d(x, w, stride=stride, padding=conv_pad(w.shape[-1], stride))
    if bias is None and alpha is None:
        return y
    y = y.float()
    if bias is not None:
        y = y + bias[:, None, None]
    if alpha is not None:
        y = F.prelu(y, alpha)
    return y.to(x.dtype)


# Every output tile conv takes, in the order of preference of bfloat16 and
# of float32 at stride 1; float32 at stride 2, with its 4x larger input
# tile, prefers 8 x 16.
CONV_TILES = ((16, 16), (8, 16), (8, 8))


def conv_smem(c_in: int, c_out: int, k: int, stride: int, th: int, tw: int,
              itemsize: int) -> int:
    """Shared memory of one ``conv`` block (csrc/conv.cu): the pixel-major
    input tile of a th x tw output tile, with its halo, and the weight
    panels."""
    ih, iw = (th - 1) * stride + k, (tw - 1) * stride + k
    return (ih * iw * mma_pitch(c_in, itemsize) * itemsize
            + mma_weight_smem(k * k, *mma_layout(c_in, c_out, itemsize),
                              itemsize))


def conv_tile(c_in: int, c_out: int, k: int, stride: int,
              itemsize: int) -> tuple[int, int]:
    """Output tile (TH, TW) of ``conv`` (``_pick_tile``)."""
    tiles = CONV_TILES
    if itemsize == 4 and stride == 2:
        tiles = ((8, 16), (16, 16), (8, 8))
    return _pick_tile(tiles, lambda th, tw: conv_smem(
        c_in, c_out, k, stride, th, tw, itemsize), itemsize)


def conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
         alpha: torch.Tensor | None, stride: int = 1, *,
         tile: tuple[int, int] | None = None) -> torch.Tensor:
    """Direct KxK conv (K in 2, 3, 5; stride 1 or 2) with optional float32
    bias and PReLU slope, both applied in float32 before the cast.

    x: (T, Cin, H, W); w: (Cout, Cin, K, K) in x's type or float32 (the
    parameter itself, rounded to x's type; the kernel reads its panels,
    ``tap_panel``, packed once).  ``tile``: the kernel's output tile, else
    ``conv_tile``'s."""
    if not _on_cuda(x):
        return conv_plain(x, w.to(x.dtype), bias, alpha, stride)
    same, f32 = ((w,), ()) if w.dtype == x.dtype else ((), (w,))
    code = _check('conv', x, *same, f32=(bias, alpha, *f32))
    t, cin, h, wd = x.shape
    cout, cin_w, k, k2 = w.shape
    if cin_w != cin or k != k2 or k not in (2, 3, 5) or stride not in (1, 2):
        raise ValueError(f'conv: weight {tuple(w.shape)} stride {stride} '
                         f'for input {tuple(x.shape)}')
    pad = conv_pad(k, stride)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    size = x.element_size()
    th, tw = tile or conv_tile(cin, cout, k, stride, size)
    if conv_smem(cin, cout, k, stride, th, tw, size) > SMEM_BYTES:
        raise ValueError(f'conv: tile {th}x{tw} does not fit in shared '
                         'memory')
    out = torch.empty((t, cout, ho, wo), device=x.device, dtype=x.dtype)
    wp = tap_panel(w, x.dtype)
    np_, kp = wp.shape[1:]
    lib = _build.library()
    _build.check(lib.shiftnet_conv(
        code, x.data_ptr(), wp.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        out.data_ptr(), t, cin, cout, h, wd, k, stride, np_, kp, th, tw,
        _stream()), 'conv')
    LAUNCHES['conv'] += 1
    return out


# -- I: conv_cat ---------------------------------------------------------------

def cat_layout(n_in: int, c_in: int, c_out: int,
               itemsize: int) -> tuple[int, int]:
    """(Np, KP) of conv_cat's packed weights (csrc/conv_cat.cu): the output
    rows of ``mma_layout``, and a panel row as long as the pixel-major
    tile's, ``n_in`` inputs of ``pad_chunk(c_in)`` channels each."""
    return (mma_layout(c_in, c_out, itemsize)[0],
            mma_pitch(n_in * pad_chunk(c_in, itemsize), itemsize))


def pack_cat_taps(w: torch.Tensor, n_in: int, np_: int,
                  kp: int) -> torch.Tensor:
    """(Cout, n_in * Cin, 3, 3) -> (9, np_, kp): ``pack_taps`` with input
    s's channels at columns s * pad_chunk(Cin) onwards and zeros between,
    where csrc/conv_cat.cu stages that input in its tile; in w's type."""
    c_in = w.shape[1] // n_in
    pad = pad_chunk(c_in, w.element_size()) - c_in
    parts = [F.pad(v, (0, 0, 0, 0, 0, pad)) for v in w.chunk(n_in, dim=1)]
    return pack_taps(torch.cat(parts, dim=1), np_, kp)


def conv_cat_smem(n_in: int, c_in: int, c_out: int, itemsize: int, th: int,
                  tw: int) -> int:
    """Shared memory of one ``conv_cat`` block (csrc/conv_cat.cu,
    conv_cat_smem): the weight panels (whole, or two streamed taps) and the
    pixel-major tile of the inputs with a 1-pixel halo."""
    np_, kp = cat_layout(n_in, c_in, c_out, itemsize)
    return (mma_weight_smem(9, np_, kp, itemsize)
            + (th + 2) * (tw + 2) * kp * itemsize)


def conv_cat_tile(n_in: int, c_in: int, c_out: int,
                  itemsize: int) -> tuple[int, int]:
    """Output tile (TH, TW) of ``conv_cat`` (``_pick_tile`` over
    ``CONV_TILES``)."""
    return _pick_tile(CONV_TILES, lambda th, tw: conv_cat_smem(
        n_in, c_in, c_out, itemsize, th, tw), itemsize)


def cat_panel(w: torch.Tensor, n_in: int, dtype: torch.dtype) -> torch.Tensor:
    """The tensor-core panels of a conv over an ``n_in``-input concat, w
    (Cout, n_in * Cin, 3, 3): (9, Np, KP) in ``dtype`` (``pack_cat_taps`` at
    ``cat_layout``), the weight rounded to dtype, packed once per weight
    (``_kept_panel``)."""
    c_out, c_all = w.shape[:2]
    layout = cat_layout(n_in, c_all // n_in, c_out,
                        torch.empty((), dtype=dtype).element_size())
    return _kept_panel(w, dtype, f'_cat_panel{n_in}',
                       lambda v: pack_cat_taps(v, n_in, *layout))


def conv_concat_plain(xs, w, bias, alpha):
    ws = w.float().chunk(len(xs), dim=1)
    y = sum(F.conv2d(x.float(), wi, padding=1) for x, wi in zip(xs, ws))
    if bias is not None:
        y = y + bias[:, None, None]
    if alpha is not None:
        y = F.prelu(y, alpha)
    return y.to(xs[0].dtype)


def conv_concat(xs: list[torch.Tensor], w: torch.Tensor,
                bias: torch.Tensor | None, alpha: torch.Tensor | None, *,
                tile: tuple[int, int] | None = None) -> torch.Tensor:
    """conv3x3(cat(xs, dim=1), w) + bias, then PReLU, without the concat:
    the sum of per-input convs, accumulated in float32, with the float32
    bias and slope applied before the single cast
    (``shiftnet_tpu/ops/chw.py:conv_concat_chw``).  Stride 1.

    xs: 2 or 3 tensors (T, Cin, H, W) of one shape and type; w: the
    (Cout, n_in * Cin, 3, 3) weight of the conv over the concat, in that
    type or float32 (the parameter itself, rounded to that type; the kernel
    reads its panels, ``cat_panel``, packed once); bias: (Cout,) float32.
    ``tile``: the kernel's output tile, else ``conv_cat_tile``'s."""
    x = xs[0]
    if not _on_cuda(x):
        return conv_concat_plain(xs, w.to(x.dtype), bias, alpha)
    n_in = len(xs)
    if n_in not in (2, 3):
        raise ValueError(f'conv_cat: {n_in} inputs; takes 2 or 3')
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f'conv_cat: dtype {x.dtype} not supported')
    if (any(v.dtype != x.dtype for v in xs)
            or w.dtype not in (x.dtype, torch.float32)):
        raise ValueError('conv_cat: inputs must share one type, and the '
                         'weight be in it or float32')
    t, cin, h, wd = x.shape
    cout = w.shape[0]
    if (any(v.shape != x.shape for v in xs)
            or w.shape != (cout, n_in * cin, 3, 3)):
        raise ValueError(f'conv_cat: inputs {[tuple(v.shape) for v in xs]}, '
                         f'weight {tuple(w.shape)}: needs one input shape and '
                         'a 3x3 weight over their concat')
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f'conv_cat: bias {tuple(bias.shape)} for Cout={cout}')
    same, f32 = ((w,), ()) if w.dtype == x.dtype else ((), (w,))
    code = _check('conv_cat', x, *xs[1:], *same, f32=(bias, alpha, *f32))
    size = x.element_size()
    np_, kp = cat_layout(n_in, cin, cout, size)
    th, tw = tile or conv_cat_tile(n_in, cin, cout, size)
    if conv_cat_smem(n_in, cin, cout, size, th, tw) > SMEM_BYTES:
        raise ValueError(f'conv_cat: tile {th}x{tw} does not fit in shared '
                         'memory')
    wp = cat_panel(w, n_in, x.dtype)
    out = torch.empty((t, cout, h, wd), device=x.device, dtype=x.dtype)
    ptrs = [v.data_ptr() for v in xs] + [None] * (3 - n_in)
    lib = _build.library()
    _build.check(lib.shiftnet_conv_cat(
        code, *ptrs, n_in, wp.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        out.data_ptr(), t, cin, cout, h, wd, np_, kp, th, tw, _stream()),
        'conv_cat')
    LAUNCHES['conv_cat'] += 1
    return out


# -- D: up_skip --------------------------------------------------------------

# Low-resolution tiles up_skip takes, in bfloat16's order of preference (the
# halo recompute of the 1x1: 1.19x at 16 x 32, 1.33x at 8 x 32, 1.41x at 8
# x 16); float32, one block an SM, ran faster at 8 x 32 at the wide widths
# (tools/bench_conv.py --only up --tiles measures both orders).
UP_TILES = ((16, 32), (8, 32), (8, 16))
_UP_F32 = ((8, 32), (16, 32), (8, 16))


def up_skip_smem(c_in: int, c_out: int, itemsize: int, th: int,
                 tw: int) -> int:
    """Shared memory of one ``up_skip`` block (csrc/up_skip.cu,
    up_skip_smem): x on the tile and its 1-pixel halo and z, both
    channel-major at ``cm_pitch``, and the panel."""
    xp = cm_pitch((th + 2) * (tw + 2))
    np_, kp = mma_layout(c_in, c_out, itemsize)
    return ((pad_chunk(c_in, itemsize) + c_out) * xp + np_ * kp) * itemsize


def up_skip_tile(c_in: int, c_out: int, itemsize: int) -> tuple[int, int]:
    """Low-resolution tile (TH, TW) of ``up_skip`` (``_pick_tile``)."""
    return _pick_tile(UP_TILES if itemsize == 2 else _UP_F32,
                      lambda th, tw: up_skip_smem(c_in, c_out, itemsize, th,
                                                  tw), itemsize)


def up_skip_plain(x, w11, skip):
    return F.conv2d(bilinear_up2x(x), w11) + skip


def up_skip(x: torch.Tensor, w11: torch.Tensor, skip: torch.Tensor, *,
            tile: tuple[int, int] | None = None) -> torch.Tensor:
    """SkipUpSample: bilinear2x(conv1x1(x)) + skip, into a fresh output.

    x: (T, Cin, h, w); w11: (Cout, Cin, 1, 1), in x's type or float32 (the
    parameter itself, rounded to x's type; the kernel reads its panel,
    ``tap_panel``, packed once); skip: (T, Cout, 2h, 2w).  ``tile``: the
    kernel's low-resolution tile, else ``up_skip_tile``'s."""
    if not _on_cuda(x):
        return up_skip_plain(x, w11.to(x.dtype), skip)
    same, f32 = ((w11,), ()) if w11.dtype == x.dtype else ((), (w11,))
    code = _check('up_skip', x, skip, *same, f32=f32)
    t, cin, h, w = x.shape
    cout = w11.shape[0]
    if w11.shape != (cout, cin, 1, 1) or skip.shape != (t, cout, 2 * h, 2 * w):
        raise ValueError(f'up_skip: w {tuple(w11.shape)}, skip '
                         f'{tuple(skip.shape)}, x {tuple(x.shape)}')
    size = x.element_size()
    th, tw = tile or up_skip_tile(cin, cout, size)
    # csrc/up_skip.cu: a 16-byte blend item's place in a row is fixed per
    # thread, so the 256 threads are a multiple of a row's items
    if (up_skip_smem(cin, cout, size, th, tw) > SMEM_BYTES or tw % 4
            or th < 1 or 256 % (2 * tw * size // 16)):
        raise ValueError(f'up_skip: tile {th}x{tw} at {cin}->{cout}: not a '
                         'tile the kernel takes')
    wp = tap_panel(w11, x.dtype)
    out = torch.empty_like(skip)
    vec = (2 * w * size) % 16 == 0 and all(
        v.data_ptr() % 16 == 0 for v in (skip, out))
    lib = _build.library()
    _build.check(lib.shiftnet_up_skip(
        code, x.data_ptr(), wp.data_ptr(), skip.data_ptr(), out.data_ptr(),
        t, cin, cout, wp.shape[1], wp.shape[2], h, w, th, tw, int(vec),
        _stream()), 'up_skip')
    LAUNCHES['up_skip'] += 1
    return out


# -- the TFR U-Net on the kernels --------------------------------------------

def prefix(name: str) -> str:
    """Key prefix of a module's parameters: ``''`` names the module whose
    own ``named_parameters()`` the dict holds."""
    return f'{name}.' if name else ''


def cab(p: dict[str, torch.Tensor], name: str, x: torch.Tensor, *,
        inplace: bool = False) -> torch.Tensor:
    """Plain CAB (``layers.CAB``) as cab_front -> ca_mlp -> cab_back.
    ``p`` holds torch-named parameters; ``name`` is the CAB's prefix."""
    return _cab(p, name, x, cab_front,
                lambda x, s, ca: cab_back(x, s, ca, inplace=inplace))


def cab_plain(p: dict[str, torch.Tensor], name: str,
              x: torch.Tensor) -> torch.Tensor:
    """``cab`` on the plain versions, the weights rounded as the kernels
    round them: the twin that ``ops/chw_grad`` differentiates."""
    return _cab(p, name, x,
                lambda x, w1, a, w2: cab_front_plain(
                    x, w1.to(x.dtype), a, w2.to(x.dtype)), cab_back_plain)


def _cab(p, name, x, front, back):
    k = prefix(name)
    s, sums = front(x, p[f'{k}body.0.weight'], p[f'{k}body.1.weight'],
                    p[f'{k}body.2.weight'])
    ca = ca_mlp(sums, x.shape[2] * x.shape[3], p[f'{k}CA.conv_du.0.weight'],
                p[f'{k}CA.conv_du.2.weight'], x.dtype)
    return back(x, s, ca)


def down(p: dict[str, torch.Tensor], name: str, x: torch.Tensor, *,
         with_prelu: bool) -> torch.Tensor:
    """DownSample (``layers.DownSample``): stride-2 3x3 conv with bias, or
    bias-free followed by PReLU."""
    k = prefix(name)
    if with_prelu:
        return conv(x, p[f'{k}down.0.weight'], None, p[f'{k}down.1.weight'],
                    stride=2)
    return conv(x, p[f'{k}down.weight'], p[f'{k}down.bias'], None, stride=2)


def tfr_unet(p: dict[str, torch.Tensor], x: torch.Tensor, *,
             downsample_prelu: bool = False) -> torch.Tensor:
    """TFR_UNet (``shiftnet_tpu/ops/chw.py:tfr_unet_chw``) on the kernels.

    ``p``: the U-Net's parameters by torch name (``named_parameters()`` of a
    ``layers.TFRUNet``).  x is never written.  The CABs of the level chains
    write over their input, which is dead there: each chain starts on the
    fresh output of a down conv or an up_skip.  enc1 and enc2 are read again
    by the skip CABs, so the CABs that make them and read them write fresh
    outputs."""
    dp = dict(with_prelu=downsample_prelu)
    enc1 = cab(p, 'encoder_level1.0', x)
    y = down(p, 'down12', enc1, **dp)
    for i in range(3):
        y = cab(p, f'encoder_level2.{i}', y, inplace=True)
    enc2 = y
    y = down(p, 'down23', enc2, **dp)
    for i in range(3):
        y = cab(p, f'encoder_level3.{i}', y, inplace=True)
    for i in range(3):
        y = cab(p, f'decoder_level3.{i}', y, inplace=True)
    skip2 = cab(p, 'skip_attn2', enc2)
    del enc2
    y = up_skip(y, p['up32.up.1.weight'], skip2)
    del skip2
    for i in range(3):
        y = cab(p, f'decoder_level2.{i}', y, inplace=True)
    skip1 = cab(p, 'skip_attn1', enc1)
    del enc1
    y = up_skip(y, p['up21.up.1.weight'], skip1)
    del skip1
    return cab(p, 'decoder_level1.0', y, inplace=True)
