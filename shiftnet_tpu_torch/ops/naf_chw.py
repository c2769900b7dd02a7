"""The shift-block CUDA kernels, their plain versions, and the Encoder shift
block composed from them.

Counterpart of ``shiftnet_tpu/ops/naf_chw.py``, on logical ``(T, C, H, W)``
tensors.  An Encoder shift block is ``rounds`` x [GSTS round -> CAB2 ->
CAB1]; each gated CAB2 / CAB1 runs as three kernels with the channel
attention MLPs (``chw.ca_mlp``) as plain torch between them:

- ``shift_round`` (kernel E, ``csrc/shift_round.cu``): the temporal
  half-channel shift y and the 24-direction spatial shift hw of the moved
  channels;
- ``naf_gate`` (F, ``csrc/naf_gate.cu``): [CAB2: depthwise 3x3 over hw] ->
  LayerNorm folded into the 1x1 expand -> RepConv2 -> SimpleGate;
- ``naf_rep`` (G, ``csrc/naf_rep.cu``): [mid-CA scale] -> merged RepConv
  (grouped, or depthwise in the small variants) -> 1x1 expand ->
  SimpleGate2;
- ``naf_back`` (H, ``csrc/naf_back.cu``): y + beta * (w7 . (s * ca) + b7).

naf_gate's expand, naf_rep's grouped 5x5 and expand and naf_back's
projection run on the tensor-core conv core (``csrc/conv_core.cuh``);
their weight panels are packed once by ``prep_naf`` (``wg_p``, ``w4_p`` in
the gate interleave of ``gate_rows``, ``rep_p`` by ``pack_groups``,
``w7_p``).

Dispatch is that of ``ops/chw``: a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version (``*_plain``), and each launch
adds one to ``chw.LAUNCHES``.  The plain versions round where the XLA twin
``shiftnet_tpu/ops/chw_xla.py:naf_cab_chw_xla`` rounds, not where the
unfused flax CAB1/CAB2 do: the folded expand weight is cast once, hw2 and
the expand output e are cast before their depthwise convs, the RepConv
output r before its expand, the two SimpleGate2 factors separately, and
the products g * cag and s * ca are taken in the compute type.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from shiftnet_tpu_torch.ops import _build
from shiftnet_tpu_torch.ops.chw import (LAUNCHES, SMEM_BYTES, _check, _on_cuda,
                                        _pick_tile, _stream, ca_mlp,
                                        check_inplace, cm_pitch, mma_layout,
                                        mma_pitch, pack_taps, prefix)
from shiftnet_tpu_torch.ops.shift import gsts, ring_edge

LN_EPS = 1e-6
SBUF_PAD = 8      # csrc/naf_gate.cu, naf_rep.cu: output tile plane padding
BACK_PX = 128     # csrc/naf_back.cu, kBackPx: pixels a tile
TILES = ((16, 16), (8, 16), (8, 8))  # output tiles, largest first
REP_GROUPS = (8, 1)  # RepConv input channels per group: big, small variants


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


# -- host-side weights ---------------------------------------------------------

def prep_naf(p: dict[str, torch.Tensor], name: str, dtype: torch.dtype, *,
             mid_ca: bool = False, last_bias: bool = False,
             panels: bool = True) -> dict[str, torch.Tensor | None]:
    """Kernel-side weights of one CAB2 / CAB1 from its torch-named
    parameters (prefix ``name``), the counterpart of
    ``shiftnet_tpu/ops/naf_chw.py:prep_naf_weights`` (with
    ``naf_params_from_tree``).

    Every parameter is first rounded to the compute type, as the JAX fused
    path's ``cast_tree`` does; the results are float32 tensors:

    - ``wg`` [cin][2n]: (w0 * gamma) transposed, cast to the compute type;
      ``c1 = w0 . gamma`` and ``c2 = w0 . beta_ln`` [2n] (LayerNorm folded
      into the expand);
    - ``rep`` (n, 8, 5, 5), or (n, 1, 5, 5) for the small variants'
      depthwise RepConv: the RepConv with its 3x3 branch added to the
      centre taps and the identity to the centre tap of each channel's own
      input, merged in float32 and cast once (not the TPU's dense
      block-diagonal form, ``_dense_rep``);
    - ``dw0`` [2n][9] (RepConv2), ``dwc`` [add_c][9] (CAB2's conv1, None
      for CAB1), ``w4`` [n][2n], ``w7`` [n][n] (input-major), ``beta`` [n]
      and ``b7`` [n] (None without ``last_bias``).

    The tensor-core panels, in the compute type and holding exactly the
    values above, are packed here once, not per launch:

    - ``wg_p`` (1, 2n, mma_pitch(cin)): naf_gate's expand, output channels
      in order;
    - ``w4_p`` (1, 2n, mma_pitch(n)): naf_rep's expand, rows in the gate
      interleave of ``gate_rows``;
    - ``rep_p`` (n/8, 25, 8, mma_pitch(8)) for the grouped RepConv
      (``pack_groups``), None for the depthwise one (the kernel reads
      ``rep`` on the CUDA cores);
    - ``w7_p`` (1, n, mma_pitch(n)): naf_back's projection, output
      channels in order.

    ``panels=False`` is the differentiable form, the backward's twin of the
    kernels' weights: the same values, computed from the parameters
    themselves (not detached), so that autograd carries the LayerNorm fold
    and the RepConv merge back to ``norm.*`` and both RepConv branches;
    no panels (the plain versions read none).
    """
    k = prefix(name)

    def q(key: str) -> torch.Tensor:
        v = p[k + key]
        return (v.detach() if panels else v).to(dtype).float()

    off = 1 if mid_ca else 0
    w0 = q('body.0.weight').flatten(1)  # (2n, cin)
    n = w0.shape[0] // 2
    gamma, beta_ln = q('norm.weight'), q('norm.bias')
    # a copy: in float32, q() returns the parameter's own storage
    rep = q(f'body.{3 + off}.conv_1.weight').clone()  # (n, n/groups, 5, 5)
    cin_g = rep.shape[1]
    if cin_g not in REP_GROUPS:
        raise ValueError(f'{name}: RepConv with {cin_g} input channels per '
                         f'group; the kernel takes {REP_GROUPS}')
    rep[:, :, 1:4, 1:4] += q(f'body.{3 + off}.conv_2.weight')
    o = torch.arange(n, device=rep.device)
    rep[o, o % cin_g, 2, 2] += 1.0
    rep = rep.to(dtype).float()
    wg = (w0 * gamma).t().to(dtype).float().contiguous()
    w4 = q(f'body.{4 + off}.weight').flatten(1).t().contiguous()
    w7 = q(f'body.{7 + off}.weight').flatten(1).t().contiguous()
    prep = {
        'wg': wg,
        'c1': w0 @ gamma,
        'c2': w0 @ beta_ln,
        'dw0': q('body.1.conv_2.weight').reshape(2 * n, 9),
        'dwc': (q('conv1.weight').flatten(1) if k + 'conv1.weight' in p
                else None),
        'rep': rep,
        'w4': w4,
        'w7': w7,
        'beta': q('beta').flatten(),
        'b7': q(f'body.{7 + off}.bias') if last_bias else None,
    }
    if not panels:
        return prep
    size = torch.empty((), dtype=dtype).element_size()
    prep.update(
        wg_p=pack_taps(wg.t()[:, :, None, None].to(dtype), 2 * n,
                       mma_pitch(wg.shape[0], size)),
        w4_p=pack_taps(w4.t()[gate_rows(n), :, None, None].to(dtype),
                       2 * n, mma_pitch(n, size)),
        rep_p=pack_groups(rep.to(dtype)) if cin_g == 8 else None,
        w7_p=pack_taps(w7.t()[:, :, None, None].to(dtype),
                       *mma_layout(n, n, size)))
    return prep


def gate_rows(n: int) -> torch.Tensor:
    """The expand output channel of each row of ``w4_p``: in every 16 rows,
    8 channels o .. o + 7 and then their SimpleGate2 partners o + n ..
    o + n + 7, so a gate's two factors are the sums of one warp's two
    neighbouring n8 tiles (csrc/conv_core.cuh, conv_tile's kPair)."""
    r = torch.arange(2 * n)
    return 8 * (r // 16) + r % 8 + n * ((r % 16) >= 8).long()


def pack_groups(rep: torch.Tensor) -> torch.Tensor:
    """A grouped RepConv (n, 8, 5, 5) -> (n/8, 25, 8, mma_pitch(8)): per
    group and tap (ky * 5 + kx), the B operand of csrc/conv_core.cuh's
    group_tile, output channels on the rows, the group's 8 input channels
    along them, zero-padded; in rep's type."""
    n = rep.shape[0]
    kp = mma_pitch(8, rep.element_size())
    panels = rep.reshape(n // 8, 8, 8, 25).permute(0, 3, 1, 2)
    return F.pad(panels, (0, kp - 8)).contiguous()


# -- E: shift_round ------------------------------------------------------------

shift_round_plain = gsts


def shift_round(x: torch.Tensor, number: int, *, reverse: bool,
                boundary_patch: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One GSTS round (``ops.shift.gsts``): the temporally shifted y (T, C,
    H, W), always a fresh tensor, and hw (T, 8 * number, H, W)."""
    if not _on_cuda(x):
        return shift_round_plain(x, number, reverse=reverse,
                                 boundary_patch=boundary_patch)
    code = _check('shift_round', x)
    t, c, h, w = x.shape
    add_c = 8 * number
    if number < 1 or add_c > c:
        raise ValueError(f'shift_round: number {number} for C={c}')
    y = torch.empty_like(x)
    hw = torch.empty((t, add_c, h, w), device=x.device, dtype=x.dtype)
    lib = _build.library()
    _build.check(lib.shiftnet_shift_round(
        code, x.data_ptr(), y.data_ptr(), hw.data_ptr(), t, c, h, w, number,
        int(reverse), int(boundary_patch), _stream()), 'shift_round')
    LAUNCHES['shift_round'] += 1
    return y, hw


# -- F: naf_gate ---------------------------------------------------------------

def naf_gate_smem(n: int, add_c: int, itemsize: int, th: int, tw: int) -> int:
    """Shared memory of one ``naf_gate`` block (csrc/naf_gate.cu,
    naf_gate_smem): the expand's panel; the pixel-major [y; hw2] of the
    expand region (the tile plus a 1-pixel halo), later the g tile; the
    larger of hw with a 2-pixel halo and e (rows of 2n + 8); float32 LN
    statistics and the folded LN's terms c1, c2."""
    m1 = (th + 2) * (tw + 2)
    sx = mma_pitch(n + add_c, itemsize)
    xin = max(m1 * sx, n * (th * tw + SBUF_PAD))
    hw = (th + 4) * (tw + 4) * mma_pitch(add_c, itemsize) if add_c else 0
    return ((2 * n * sx + xin + max(m1 * (2 * n + 8), hw)) * itemsize
            + 4 * (2 * m1 + 4 * n))


def naf_gate_tile(n: int, add_c: int, itemsize: int) -> tuple[int, int]:
    """Output tile (TH, TW) of ``naf_gate`` (``chw._pick_tile``)."""
    return _pick_tile(TILES, lambda th, tw: naf_gate_smem(
        n, add_c, itemsize, th, tw), itemsize)


def naf_gate_plain(y, hw, prep):
    dt = y.dtype
    n = y.shape[1]
    xin = y
    if hw is not None:
        add_c = hw.shape[1]
        hw2 = F.conv2d(hw.float(), prep['dwc'].view(add_c, 1, 3, 3),
                       padding=1, groups=add_c).to(dt)
        xin = torch.cat([y, hw2], dim=1)
    x32 = xin.float()
    cin = x32.shape[1]
    mu = x32.sum(dim=1, keepdim=True) / cin
    var = x32.square().sum(dim=1, keepdim=True) / cin - mu * mu
    inv = torch.rsqrt(var + LN_EPS)
    e = torch.einsum('io,tihw->tohw', prep['wg'], x32)
    e = (inv * e - (inv * mu) * _col(prep['c1']) + _col(prep['c2'])).to(dt)
    e32 = e.float()
    d = F.conv2d(e32, prep['dw0'].view(2 * n, 1, 3, 3), padding=1,
                 groups=2 * n) + e32
    g = (d[:, :n] * d[:, n:]).to(dt).contiguous()
    return g, g.float().sum(dim=(2, 3))


def _sum_rows(device: torch.device) -> int:
    """Rows of the naf kernels' sums buffer: the most blocks their grids take
    (persistent, two blocks an SM at most; csrc/conv_core.cuh,
    persistent_grid), each summing its own tiles of a frame into its row."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def _fit(name: str, smem: int, th: int, tw: int) -> None:
    if smem > SMEM_BYTES or tw % 8 or th < 1:
        raise ValueError(f'{name}: tile {th}x{tw}: not a tile the kernel '
                         'takes')


def naf_gate(y: torch.Tensor, hw: torch.Tensor | None, prep: dict, *,
             tile: tuple[int, int] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """[CAB2: hw2 = dw3x3(hw)] -> LayerNorm over [y; hw2] folded into the
    expand to 2n -> RepConv2 -> SimpleGate.  ``hw=None`` for CAB1.

    y: (T, n, H, W), n in 32, 48, 64, 80; hw: (T, add_c, H, W).  ``tile``:
    the kernel's output tile, else ``naf_gate_tile``'s.  Returns g (T, n,
    H, W) and its float32 channel sums (T, n)."""
    if not _on_cuda(y):
        return naf_gate_plain(y, hw, prep)
    wg, c1, c2, dw0, dwc = (prep[k] for k in ('wg_p', 'c1', 'c2', 'dw0',
                                              'dwc'))
    code = _check('naf_gate', y, hw, wg, f32=(c1, c2, dw0, dwc))
    t, n, h, w = y.shape
    add_c = 0 if hw is None else hw.shape[1]
    size = y.element_size()
    np_, kp = mma_layout(n + add_c, 2 * n, size, expand=True)
    if ((hw is None) != (dwc is None) or add_c % 8
            or (hw is not None and hw.shape != (t, add_c, h, w))
            or wg.shape != (1, np_, kp) or dw0.shape != (2 * n, 9)
            or (dwc is not None and dwc.shape != (add_c, 9))):
        raise ValueError(f'naf_gate: y {tuple(y.shape)}, hw '
                         f'{None if hw is None else tuple(hw.shape)}, wg_p '
                         f'{tuple(wg.shape)}')
    th, tw = tile or naf_gate_tile(n, add_c, size)
    _fit('naf_gate', naf_gate_smem(n, add_c, size, th, tw), th, tw)
    rows = _sum_rows(y.device)
    g = torch.empty_like(y)
    part = torch.zeros((t, rows, n), device=y.device, dtype=torch.float32)
    lib = _build.library()
    _build.check(lib.shiftnet_naf_gate(
        code, y.data_ptr(), None if hw is None else hw.data_ptr(),
        wg.data_ptr(), c1.data_ptr(), c2.data_ptr(), dw0.data_ptr(),
        None if dwc is None else dwc.data_ptr(), g.data_ptr(), part.data_ptr(),
        t, n, add_c, h, w, th, tw, rows, LN_EPS, _stream()), 'naf_gate')
    LAUNCHES['naf_gate'] += 1
    return g, part.sum(dim=1)


# -- G: naf_rep ----------------------------------------------------------------

def naf_rep_smem(n: int, itemsize: int, th: int, tw: int,
                 group: int = 8) -> int:
    """Shared memory of one ``naf_rep`` block (csrc/naf_rep.cu,
    naf_rep_smem): g with a 2-pixel halo (later the s tile), r of the tile,
    both pixel-major, the expand's panel and, grouped, all groups' 5x5
    panels."""
    sp = mma_pitch(n, itemsize)
    tt = th * tw
    g = max((th + 4) * (tw + 4) * sp, n * (tt + SBUF_PAD))
    w_grp = (n // 8) * 25 * 8 * mma_pitch(8, itemsize) if group == 8 else 0
    return (g + tt * sp + w_grp + 2 * n * sp) * itemsize


def naf_rep_tile(n: int, itemsize: int, group: int = 8) -> tuple[int, int]:
    """Output tile (TH, TW) of ``naf_rep`` (``chw._pick_tile``)."""
    return _pick_tile(TILES, lambda th, tw: naf_rep_smem(
        n, itemsize, th, tw, group), itemsize)


def naf_rep_plain(g, cag, prep):
    dt = g.dtype
    n = g.shape[1]
    if cag is not None:
        g = g * cag[:, :, None, None]
    r = F.conv2d(g.float(), prep['rep'], padding=2,
                 groups=n // prep['rep'].shape[1]).to(dt)
    e2 = torch.einsum('io,tihw->tohw', prep['w4'], r.float())
    s = (e2[:, :n].to(dt) * torch.sigmoid(e2[:, n:]).to(dt)).contiguous()
    return s, s.float().sum(dim=(2, 3))


def naf_rep(g: torch.Tensor, cag: torch.Tensor | None, prep: dict, *,
            tile: tuple[int, int] | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """[g * cag] -> merged RepConv (grouped, or depthwise when ``prep['rep']``
    is (n, 1, 5, 5)) -> expand n -> 2n -> SimpleGate2.  g: (T, n, H, W), n
    in 32, 48, 64, 80; ``cag``: the (T, n) mid-CALayer scale in g's type, or
    None.  ``tile``: the kernel's output tile, else ``naf_rep_tile``'s.
    Returns s (T, n, H, W) and its float32 channel sums (T, n)."""
    if not _on_cuda(g):
        return naf_rep_plain(g, cag, prep)
    rep, w4 = prep['rep'], prep['w4_p']
    cin_g = rep.shape[1]
    # grouped: the packed panels in g's type; depthwise: float32 [n][25]
    rep_k = prep['rep_p'] if cin_g == 8 else rep
    code = _check('naf_rep', g, cag, w4, *((rep_k,) if cin_g == 8 else ()),
                  f32=(rep,))
    t, n, h, w = g.shape
    size = g.element_size()
    np_, kp = mma_layout(n, 2 * n, size, expand=True)
    if (cin_g not in REP_GROUPS or rep.shape != (n, cin_g, 5, 5)
            or w4.shape != (1, np_, kp)
            or (cin_g == 8 and rep_k.shape != (n // 8, 25, 8,
                                               mma_pitch(8, size)))
            or (cag is not None and cag.shape != (t, n))):
        raise ValueError(f'naf_rep: g {tuple(g.shape)}, rep '
                         f'{tuple(rep.shape)}, w4_p {tuple(w4.shape)}')
    th, tw = tile or naf_rep_tile(n, size, cin_g)
    _fit('naf_rep', naf_rep_smem(n, size, th, tw, cin_g), th, tw)
    rows = _sum_rows(g.device)
    s = torch.empty_like(g)
    part = torch.zeros((t, rows, n), device=g.device, dtype=torch.float32)
    lib = _build.library()
    _build.check(lib.shiftnet_naf_rep(
        code, g.data_ptr(), None if cag is None else cag.data_ptr(),
        rep_k.data_ptr(), w4.data_ptr(), s.data_ptr(), part.data_ptr(), t, n,
        cin_g, h, w, th, tw, rows, _stream()), 'naf_rep')
    LAUNCHES['naf_rep'] += 1
    return s, part.sum(dim=1)


# -- H: naf_back ---------------------------------------------------------------

def naf_back_plain(y, s, ca, prep, inplace=False):
    sc = (s * ca[:, :, None, None]).float()
    y7 = torch.einsum('io,tihw->tohw', prep['w7'], sc)
    if prep['b7'] is not None:
        y7 = y7 + _col(prep['b7'])
    out = (y.float() + y7 * _col(prep['beta'])).to(y.dtype)
    return y.copy_(out) if inplace else out.contiguous()


def naf_back_smem(n: int, itemsize: int) -> int:
    """Shared memory of one ``naf_back`` block (csrc/naf_back.cu,
    naf_back_smem): two stages of the s and y tiles, channel-major at
    ``cm_pitch(BACK_PX)``, and ca; the panel."""
    stage = 2 * n * cm_pitch(BACK_PX) + n
    return (2 * stage + n * mma_pitch(n, itemsize)) * itemsize


def naf_back(y: torch.Tensor, s: torch.Tensor, ca: torch.Tensor, prep: dict,
             *, inplace: bool = False) -> torch.Tensor:
    """out = y + beta * (w7 . (s * ca) + b7).  ``ca``: (T, n) in y's type.
    ``inplace`` writes over y: only for callers that know y is dead."""
    check_inplace('naf_back', y, inplace)
    if not _on_cuda(y):
        return naf_back_plain(y, s, ca, prep, inplace)
    w7, w7_p, beta, b7 = prep['w7'], prep['w7_p'], prep['beta'], prep['b7']
    code = _check('naf_back', y, s, ca, w7_p, f32=(w7, beta, b7))
    t, n, h, w = y.shape
    size = y.element_size()
    if (n % 8 or s.shape != y.shape or ca.shape != (t, n)
            or w7.shape != (n, n) or beta.shape != (n,)
            or w7_p.shape != (1, *mma_layout(n, n, size))
            or (b7 is not None and b7.shape != (n,))):
        raise ValueError(f'naf_back: y {tuple(y.shape)}, s {tuple(s.shape)}, '
                         f'ca {tuple(ca.shape)}, w7_p {tuple(w7_p.shape)}')
    if naf_back_smem(n, size) > SMEM_BYTES:
        raise ValueError(f'naf_back: n={n} does not fit in shared memory')
    out = y if inplace else torch.empty_like(y)
    aligned = (h * w * size) % 16 == 0 and all(
        v.data_ptr() % 16 == 0 for v in (y, s, ca, out))
    lib = _build.library()
    _build.check(lib.shiftnet_naf_back(
        code, y.data_ptr(), s.data_ptr(), ca.data_ptr(), w7_p.data_ptr(),
        beta.data_ptr(), None if b7 is None else b7.data_ptr(),
        out.data_ptr(), t, n, h * w, int(aligned), _stream()), 'naf_back')
    LAUNCHES['naf_back'] += 1
    return out


# -- CAB2 / CAB1 and the Encoder shift block on the kernels --------------------

def naf_cab(p: dict[str, torch.Tensor], name: str, y: torch.Tensor,
            hw: torch.Tensor | None = None, *, mid_ca: bool = False,
            last_bias: bool = False, inplace: bool = False) -> torch.Tensor:
    """CAB2 (``hw`` given) or CAB1 (``layers.CAB2`` / ``CAB1``) as naf_gate
    -> [ca_mlp] -> naf_rep -> ca_mlp -> naf_back, the counterpart of
    ``shiftnet_tpu/ops/naf_chw.py:naf_cab_chw``.  ``p`` holds torch-named
    parameters, ``name`` is the block's prefix.  ``inplace`` writes the
    result over y."""
    return _naf_cab(p, name, y, hw, mid_ca, last_bias, naf_gate, naf_rep,
                    functools.partial(naf_back, inplace=inplace), True)


def naf_cab_plain(p: dict[str, torch.Tensor], name: str, y: torch.Tensor,
                  hw: torch.Tensor | None = None, *, mid_ca: bool = False,
                  last_bias: bool = False) -> torch.Tensor:
    """``naf_cab`` on the plain versions from the differentiable weights
    (``prep_naf(panels=False)``): the same function, which autograd
    differentiates back to every raw parameter (``ops/chw_grad``)."""
    return _naf_cab(p, name, y, hw, mid_ca, last_bias, naf_gate_plain,
                    naf_rep_plain, naf_back_plain, False)


def _naf_cab(p, name, y, hw, mid_ca, last_bias, gate, rep, back, panels):
    dt = y.dtype
    k = prefix(name)
    off = 1 if mid_ca else 0
    n_px = y.shape[2] * y.shape[3]
    prep = prep_naf(p, name, dt, mid_ca=mid_ca, last_bias=last_bias,
                    panels=panels)
    g, gsums = gate(y, hw, prep)
    cag = None
    if mid_ca:
        cag = ca_mlp(gsums, n_px, p[f'{k}body.3.conv_du.0.weight'],
                     p[f'{k}body.3.conv_du.2.weight'], dt)
    s, sums = rep(g, cag, prep)
    del g
    ca = ca_mlp(sums, n_px, p[f'{k}body.{6 + off}.conv_du.0.weight'],
                p[f'{k}body.{6 + off}.conv_du.2.weight'], dt)
    return back(y, s, ca, prep)


def encoder_shift_block(p: dict[str, torch.Tensor], x: torch.Tensor, *,
                        rounds: int, boundary_patch: bool,
                        mid_ca: bool = False, last_bias: bool = False,
                        group=None) -> torch.Tensor:
    """``Encoder_shift_block`` (``layers.EncoderShiftBlock``) on the
    kernels, the counterpart of ``shiftnet_tpu/ops/naf_chw.py:
    encoder_shift_block_chw``: ``rounds`` x [shift_round -> CAB2 -> CAB1],
    forward first, then alternating.  ``p``: the block's own
    ``named_parameters()``.  x is never written.

    ``group`` (sequence parallelism, JAX's ``axis``): shift_round runs
    on the rank's frames, and ``ops.shift.ring_edge`` rewrites the one
    frame that takes its half-channels from the neighbouring rank (JAX
    runs the whole shift as plain XLA there, ``naf_chw.py:1399-1405``)."""
    number = x.shape[1] // 2 // 8
    kw = dict(mid_ca=mid_ca, last_bias=last_bias)
    for r in range(rounds):
        blk = 'encoder_level1' if r == 0 else f'encoder_level1_{r}'
        y, hw = shift_round(x, number, reverse=r % 2 == 1,
                            boundary_patch=boundary_patch)
        if group is not None:
            ring_edge(x, y, hw, number, reverse=r % 2 == 1,
                      boundary_patch=boundary_patch, group=group)
        # Both blocks write in place: CAB2's y is the fresh output of
        # shift_round and CAB1's input is CAB2's output; neither is read
        # again.
        x = naf_cab(p, f'{blk}.0', y, hw, inplace=True, **kw)
        del y, hw
        x = naf_cab(p, f'{blk}.1', x, inplace=True, **kw)
    return x
