"""The port's measurement probes (``shiftnet_tpu_torch/ops/probes.py``)
against the Pallas probe kernels of the JAX package's ``tools/``, on the CPU.

For rows 11, 13, 15a, 15b, 16a and 16b of PERF.md's kernel table, the JAX
tool's own kernel body runs in TPU interpret mode, in a ``pallas_call``
built as the tool builds it, on inputs made with numpy from a seed; the
port's plain version (what the wrapper runs for a CPU tensor) must equal it
bit for bit (copies) or within one bf16 ulp at the largest output
(``mm_loop``, whose float32 sums come in another order).  The tools are
loaded by file path; they set the JAX compilation cache at import, so the
fixture points it at a temporary directory and restores the config after.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels.py``.
"""
import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from shiftnet_tpu_torch.ops import chw, probes
from shiftnet_tpu_torch.tools import microbench_mm as port_mm

REPO = Path(__file__).resolve().parents[1]
TOOLS = ('microbench_mm', 'probe_hbm_copy', 'probe_copy_bw',
         'probe_dma_align')
CONFIG_KEYS = ('jax_compilation_cache_dir',
               'jax_persistent_cache_min_compile_time_secs')
PORT_TOOLS = ('microbench_mm', 'microbench', 'probe_hbm_copy', 'probe_chw',
              'probe_copy_bw', 'probe_dma_align', 'probe_launch', 'bench')


@pytest.fixture(scope='module')
def tools(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv('JAX_COMPILATION_CACHE_DIR',
              str(tmp_path_factory.mktemp('jax_cache')))
    saved = {k: getattr(jax.config, k) for k in CONFIG_KEYS}
    mods = {}
    try:
        for name in TOOLS:
            spec = importlib.util.spec_from_file_location(
                f'jax_tool_{name}', REPO / 'tools' / f'{name}.py')
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        yield mods
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        mp.undo()


def bf16_bits(a) -> np.ndarray:
    """The raw 16 bits of a bf16 JAX array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def both(arr: np.ndarray):
    """The same float32 numpy array as a bf16 JAX array and torch tensor."""
    return jnp.asarray(arr, jnp.bfloat16), torch.from_numpy(arr).bfloat16()


@pytest.mark.parametrize('m,k,n,iters', [(16, 32, 64, 3),
                                         (24, 216, 24, 2),   # K=216, N=24
                                         (40, 80, 160, 2)])  # c80 expand
def test_mm_loop_matches_jax_kernel(tools, m, k, n, iters):
    """Row 11, ``tools/microbench_mm.py:16`` ``mm_loop_kernel``."""
    rng = np.random.default_rng(m + k + n)
    ja, ta = both(rng.uniform(0, 1, (m, k)).astype(np.float32))
    jb, tb = both(rng.uniform(0, 1, (k, n)).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            functools.partial(tools['microbench_mm'].mm_loop_kernel,
                              iters=iters),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
            scratch_shapes=[pltpu.VMEM((m, n), jnp.float32)])
        want = torch.from_numpy(np.asarray(fn(ja, jb), np.float32))
    got = probes.mm_loop(ta, tb, iters)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert port_mm.mm_err(got, want) <= port_mm.MM_TOL


def test_hbm_copy_matches_jax_kernel(tools):
    """Row 13, ``tools/probe_hbm_copy.py:29`` ``_copy_kernel``, at the
    tool's own shape; only the rows it writes are compared."""
    t, rows, c, m = 4, 40, 128, 1024
    jx, tx = both(np.random.default_rng(0).standard_normal(
        (t, c, m)).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            functools.partial(tools['probe_hbm_copy']._copy_kernel, t=t,
                              rows=rows, m=m),
            grid=(t,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            out_shape=jax.ShapeDtypeStruct((t, c, m), jnp.bfloat16),
            scratch_shapes=[pltpu.SemaphoreType.DMA(())])
        want = bf16_bits(fn(jx))[:, 40:40 + rows]
    pieces = probes.hbm_copy_pieces(t, 40, rows)
    got = probes.block_copy(tx, tx.shape, pieces, m)
    np.testing.assert_array_equal(
        bf16_bits(probes.written(got, pieces, m)), want.reshape(-1))


@pytest.mark.parametrize('n_tiles', [1, 2])
def test_permutation_matches_jax_kernels(tools, n_tiles):
    """Rows 15a and 15b, ``tools/probe_copy_bw.py:45`` ``_hbm_kernel`` and
    ``:61`` ``_vmem_kernel``, at t 3, pp 2, cb 16, half 8: direct over all
    lanes, staged in the tool's lane tiles (the lanes past n_tiles * tl are
    left unwritten by both and not compared)."""
    t, pp, cb, half, lp = 3, 2, 16, 8, 320
    tool = tools['probe_copy_bw']
    jx, tx = both(np.random.default_rng(n_tiles).standard_normal(
        (t, pp * cb, lp)).astype(np.float32))
    shape = jax.ShapeDtypeStruct((t, pp * cb, lp), jnp.bfloat16)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    tl = lp // n_tiles
    tl -= tl % 128
    with pltpu.force_tpu_interpret_mode():
        hbm = pl.pallas_call(
            functools.partial(tool._hbm_kernel, t=t, half=half, pp=pp,
                              cb=cb),
            grid=(t,), in_specs=[any_spec], out_specs=any_spec,
            out_shape=shape, scratch_shapes=[pltpu.SemaphoreType.DMA(())])
        vmem = pl.pallas_call(
            functools.partial(tool._vmem_kernel, t=t, half=half, pp=pp,
                              cb=cb, tl=tl, n_tiles=n_tiles),
            grid=(t, n_tiles), in_specs=[any_spec], out_specs=any_spec,
            out_shape=shape,
            scratch_shapes=[pltpu.VMEM((2, pp * cb, tl), jnp.bfloat16),
                            pltpu.SemaphoreType.DMA((2,)),
                            pltpu.SemaphoreType.DMA((2,))])
        want_hbm, want_vmem = bf16_bits(hbm(jx)), bf16_bits(vmem(jx))
    pieces = probes.shift_pieces(t, pp, cb, half)
    np.testing.assert_array_equal(
        bf16_bits(probes.block_copy(tx, tx.shape, pieces, lp)), want_hbm)
    used = n_tiles * tl
    got = probes.block_copy_staged(tx, tx.shape, pieces, used, tile=tl)
    np.testing.assert_array_equal(bf16_bits(got)[..., :used],
                                  want_vmem[..., :used])


@pytest.mark.parametrize('off', [40, 8])
def test_dma_offset_matches_jax_kernel(tools, off):
    """Row 16a, ``tools/probe_dma_align.py:34`` ``_dma_off_kernel``, at the
    tool's own shape (rows 48 of a (128, 1024) slab)."""
    rows, m = 48, 1024
    jx, tx = both(np.random.default_rng(0).standard_normal(
        (128, m)).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            functools.partial(tools['probe_dma_align']._dma_off_kernel,
                              off=off, rows=rows, m=m),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((rows, m), jnp.bfloat16),
            scratch_shapes=[pltpu.VMEM((rows, m), jnp.bfloat16),
                            pltpu.SemaphoreType.DMA(())])
        want = bf16_bits(fn(jx))
    got = probes.block_copy_staged(tx[None], (1, rows, m),
                                   [(0, off, 0, 0, rows)], m)
    np.testing.assert_array_equal(bf16_bits(got[0]), want)


@pytest.mark.parametrize('off', [40, 8])
def test_value_slice_matches_jax_kernel(tools, off):
    """Row 16b, ``tools/probe_dma_align.py:64`` ``_slice_kernel``, at the
    tool's own shape (rows 40 of a (128, 1024) slab)."""
    rows, m = 40, 1024
    jx, tx = both(np.random.default_rng(1).standard_normal(
        (128, m)).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            functools.partial(tools['probe_dma_align']._slice_kernel,
                              off=off, rows=rows),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((rows, m), jnp.bfloat16))
        want = bf16_bits(fn(jx))
    got = probes.block_copy(tx[None], (1, rows, m), [(0, off, 0, 0, rows)],
                            m)
    np.testing.assert_array_equal(bf16_bits(got[0]), want)


def test_copy_x2_plain_matches_numpy():
    """Row 12, ``tools/microbench.py:126`` ``copy_kernel``, a closure in
    the tool's ``main()`` that cannot be called alone: its statement
    ``out[0] = buf * 2.0`` for 32-row slabs of x[0], restated in numpy (the
    doubling of a bf16 value is exact), against the staged copy's plain
    version at (2, 96, 8 * 24)."""
    x = np.random.default_rng(2).standard_normal((2, 96, 8 * 24)).astype(
        np.float32)
    tx = torch.from_numpy(x).bfloat16()
    pieces = probes.slab_pieces(96, 32)
    got = probes.block_copy_staged(tx, (1, 96, 192), pieces, 192, scale=2.0)
    want = torch.from_numpy(tx.float().numpy()[:1] * 2.0).bfloat16()
    np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))


@pytest.mark.parametrize('mode', ['lane', 'block', 'store'])
def test_strided_plain_matches_numpy(mode):
    """Rows 14a-c, ``tools/probe_chw.py:119`` ``k_lane_stride``, ``:135``
    ``k_sub_stride`` and ``:152`` ``k_store``, closures in the tool's
    ``probe_stride()`` that cannot be called alone: on the tool's input,
    x = arange(24 * 2560) in bf16, the references the tool checks against
    (``x[:, ::2]``; ``out[:, ::2] == a`` over ``zeros_like``) and the
    sublane slice it states, restated in numpy."""
    c, m = 24, 2560
    x = np.arange(c * m, dtype=np.float32).reshape(c, m)
    xb = torch.from_numpy(x).bfloat16()
    xn = xb.float().numpy()
    if mode == 'lane':
        got, want = probes.strided_copy(xb, 'lane'), xn[:, ::2]
    elif mode == 'block':
        got = probes.strided_copy(xb, 'block')
        want = xn.reshape(c, m // 128, 128)[:, ::2].reshape(c, m // 2)
    else:
        a = xb[:, :m // 2].contiguous()
        got = probes.strided_copy(a, 'store')
        want = np.zeros((c, m), np.float32)
        want[:, ::2] = xn[:, :m // 2]
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_piece_lists_match_numpy():
    """The wrapper's pieces and their element offsets: the wrap at t = 0
    (frame 0 reads frame T - 1 in the permutation, itself in the HBM copy),
    and a source 6 bytes into its rows and destination rows of an odd
    length, neither on the 16-byte grid, indexed into the flattened tensors
    as the kernels index."""
    assert probes.hbm_copy_pieces(3, 40, 5) == [
        (0, 40, 0, 40, 5), (0, 40, 1, 40, 5), (1, 40, 2, 40, 5)]
    assert probes.shift_pieces(2, 2, 6, 3) == [
        (1, 3, 0, 0, 3), (0, 0, 0, 3, 3), (1, 9, 0, 6, 3), (0, 6, 0, 9, 3),
        (0, 3, 1, 0, 3), (1, 0, 1, 3, 3), (0, 9, 1, 6, 3), (1, 6, 1, 9, 3)]
    assert probes.slab_pieces(100, 32) == [
        (0, 0, 0, 0, 32), (0, 32, 0, 32, 32), (0, 64, 0, 64, 32)]

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, 37)).astype(np.float32)
    tx = torch.from_numpy(x).bfloat16()
    out_shape, lanes, src_lane = (2, 9, 41), 29, 3
    pieces = [(2, 4, 0, 1, 7), (0, 0, 1, 0, 9)]
    table = probes.piece_table('test', tx, out_shape, pieces, lanes,
                               src_lane)
    got = probes.block_copy_staged(tx, out_shape, pieces, lanes, tile=8,
                                   src_lane=src_lane)
    flat_x, flat_out = x.reshape(-1), got.float().numpy().reshape(-1)
    xb = tx.float().numpy()
    for (sf, sr, df, dr, rows), (src, dst, n) in zip(
            pieces, np.reshape(table, (-1, 3))):
        assert n == rows
        for i in range(rows):
            want = xb[sf, sr + i, src_lane:src_lane + lanes]
            s0, d0 = src + i * x.shape[2], dst + i * out_shape[2]
            np.testing.assert_array_equal(
                flat_x[s0:s0 + lanes].astype(np.float32),
                x[sf, sr + i, src_lane:src_lane + lanes])
            np.testing.assert_array_equal(flat_out[d0:d0 + lanes], want)
        assert src % 8 != 0 or dst % 8 != 0  # not 16-byte aligned
    with pytest.raises(ValueError):  # a piece past the source's rows
        probes.piece_table('test', tx, out_shape, [(0, 8, 0, 0, 5)], lanes)
    with pytest.raises(ValueError):  # lanes past the source's
        probes.piece_table('test', tx, out_shape, pieces, 35, src_lane)
    with pytest.raises(ValueError):  # lanes past the output's
        probes.piece_table('test', tx, (2, 9, 30), pieces, 31)


def run_plan(x: torch.Tensor, plan: probes.TmaPlan, out: torch.Tensor,
             scale: float = 1.0) -> torch.Tensor:
    """``block_copy_tma_kernel``'s boxes, executed with tensor slicing: each
    box loaded from the 2-D source map (zeros outside it) at a lane on the
    16-byte grid, shifted and scaled, then stored through its run's 3-D
    map, which writes nothing outside the run's rows and lanes.  Returns
    how often each element of ``out`` was written."""
    src = x.reshape(plan.src_rows, plan.src_lanes)
    flat = out.view(-1)
    writes = torch.zeros(out.numel(), dtype=torch.int16)
    for b in range(plan.n_boxes):
        p, r0, l0 = plan.locate(b)
        src_row, run, slot, _ = plan.pieces[p]
        box = torch.zeros((plan.box_rows, plan.load_lanes), dtype=x.dtype)
        rs, ls = src_row + r0, plan.src_lane - plan.shift + l0
        assert ls % 8 == 0  # a load starts on the 16-byte grid
        part = src[rs:rs + plan.box_rows, ls:ls + plan.load_lanes]
        box[:part.shape[0], :part.shape[1]] = part
        box = box[:, plan.shift:plan.shift + plan.box_lanes]
        if scale != 1.0:
            box = box * scale
        dst, rows, n, step = plan.runs[run]
        shape, strides = (n, rows, plan.lanes), (step, plan.dst_ld, 1)
        nr = min(plan.box_rows, rows - r0)
        nl = min(plan.box_lanes, plan.lanes - l0)
        flat.as_strided(shape, strides, dst)[
            slot, r0:r0 + nr, l0:l0 + nl] = box[:nr, :nl]
        writes.as_strided(shape, strides, dst)[
            slot, r0:r0 + nr, l0:l0 + nl] += 1
    return writes


# Staged copies at the probe tools' shapes (only the frames a copy reads;
# the permutations' lanes cut, keeping the JAX tool's pp 4 and the port's pp
# 1 and a copy large enough for persistent blocks); then pieces whose rows
# (over 256) and lanes (not 8-aligned, narrower than the output's rows) are
# not multiples of the box, beside other rows of the output; then more runs
# than the kernel parameter holds.
TMA_CASES = {  # x shape, out shape, pieces, lanes, src_lane, scale
    'dma_offset_40': ((1, 128, 1024), (1, 48, 1024), [(0, 40, 0, 0, 48)],
                      1024, 0, 1.0),
    'dma_offset_8': ((1, 128, 1024), (1, 48, 1024), [(0, 8, 0, 0, 48)],
                     1024, 0, 1.0),
    'dma_lane_3': ((1, 128, 1024), (1, 48, 1016), [(0, 40, 0, 0, 48)],
                   1016, 3, 1.0),
    'slabs_x2': ((1, 384, 30720), (1, 384, 30720),
                 probes.slab_pieces(384, 32), 30720, 0, 2.0),
    'permute_pp4': ((12, 320, 1032), (12, 320, 1032),
                    probes.shift_pieces(12, 4, 80, 40), 1024, 0, 1.0),
    'permute_pp1': ((4, 80, 4000), (4, 80, 4000),
                    probes.shift_pieces(4, 1, 80, 40), 4000, 0, 1.0),
    'ragged': ((2, 300, 1000), (3, 310, 1000),
               [(0, 1, 1, 3, 293), (1, 5, 2, 0, 293), (1, 0, 0, 300, 9)],
               997, 2, 2.0),
    'many_runs': ((1, 200, 64), (1, 200, 64),
                  [(0, 15 * i, 0, 16 * i, 3 + i) for i in range(12)], 56, 8,
                  1.0),
}


@pytest.mark.parametrize('case', list(TMA_CASES))
def test_tma_plan_reproduces_the_copy(case):
    """The TMA route's boxes (``probes.tma_plan``), run as the kernel runs
    them, write every element of every piece once, bit for bit as
    ``block_copy_plain``, and nothing else: the stores clip at each run's
    rows and lanes."""
    x_shape, out_shape, pieces, lanes, src_lane, scale = TMA_CASES[case]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        x_shape).astype(np.float32)).bfloat16()
    assert probes.staged_route(x, out_shape) == 'tma'
    plan = probes.tma_plan(x.shape, out_shape, pieces, lanes, src_lane)
    assert plan.box_rows <= probes.BOX_MAX and plan.box_lanes % 8 == 0
    assert plan.load_lanes <= probes.BOX_MAX
    assert plan.stride <= probes.STAGE_BYTES and plan.stride % 128 == 0
    assert plan.smem() <= chw.SMEM_BYTES
    if case == 'many_runs':
        assert len(plan.runs) > probes.PARAM_MAPS
    elif case.startswith(('dma', 'slabs', 'permute')):
        assert len(plan.runs) == 1
    out = torch.full(out_shape, float('nan'), dtype=torch.bfloat16)
    writes = run_plan(x, plan, out, scale)
    want = probes.block_copy_plain(x, out_shape, pieces, lanes, src_lane,
                                   scale)
    np.testing.assert_array_equal(
        bf16_bits(probes.written(out, pieces, lanes)),
        bf16_bits(probes.written(want, pieces, lanes)))
    mask = torch.zeros(out_shape, dtype=torch.bool)
    for _, _, df, dr, rows in pieces:
        mask[df, dr:dr + rows, :lanes] = True
    assert (writes[mask.view(-1)] == 1).all()
    assert (writes[~mask.view(-1)] == 0).all()


@pytest.mark.parametrize('x_shape,out_shape,pieces,lanes,src_lane', [
    ((16, 384, 30720), (1, 384, 30720), probes.slab_pieces(384, 32), 30720,
     0),
    ((12, 320, 72320), (12, 320, 72320), probes.shift_pieces(12, 4, 80, 40),
     71680, 0),
    ((12, 320, 72320), (12, 320, 72320), probes.shift_pieces(12, 4, 80, 40),
     72192, 0),
    ((40, 80, 230400), (40, 80, 230400), probes.shift_pieces(40, 1, 80, 40),
     230400, 0),
    ((1, 128, 1024), (1, 48, 1016), [(0, 40, 0, 0, 48)], 1016, 3)])
def test_probe_tool_shapes_take_the_tma_route(x_shape, out_shape, pieces,
                                              lanes, src_lane):
    """Every staged copy the probe tools and ``chip_smoke.py`` make, at its
    full shape: the TMA route, one run, whole boxes of at most a stage,
    every box of every piece (the boxes of a piece tile its rows and
    lanes), boxes in whole 128-byte lines, and blocks that fit in shared
    memory: one box each where one wave holds them, else persistent,
    several an SM."""
    x = torch.empty(x_shape, dtype=torch.bfloat16, device='meta')
    assert probes.staged_route(x, out_shape) == 'tma'
    plan = probes.tma_plan(x_shape, out_shape, pieces, lanes, src_lane)
    assert len(plan.runs) == 1 and plan.runs[0][2] == len(pieces)
    assert plan.stride <= probes.STAGE_BYTES
    assert plan.lane_boxes * plan.box_lanes >= lanes
    assert (plan.lane_boxes - 1) * plan.box_lanes < lanes
    assert plan.n_boxes == sum(-(-p[4] // plan.box_rows) * plan.lane_boxes
                               for p in pieces)
    assert plan.smem() <= chw.SMEM_BYTES
    assert plan.box_lanes % probes.LINE_LANES == 0
    if plan.stages == 1:  # one box a block
        assert plan.blocks == plan.n_boxes
    else:
        assert probes.SMS < plan.blocks <= plan.n_boxes
        per = -(-plan.n_boxes // plan.blocks)
        assert (per - 1) * plan.blocks < plan.n_boxes


def test_unaligned_copies_keep_the_cp_async_route():
    """A tensor map needs 16-byte strides and a 16-byte aligned base: rows
    of an odd number of elements, on either side, or a source that starts
    off the grid take the cp.async route."""
    x = torch.zeros((2, 20, 336), dtype=torch.bfloat16)
    assert probes.staged_route(x, (2, 25, 336)) == 'tma'
    assert probes.staged_route(x, (2, 25, 341)) == 'cp.async'
    odd = torch.zeros((2, 20, 333), dtype=torch.bfloat16)
    assert probes.staged_route(odd, (2, 25, 336)) == 'cp.async'
    shifted = torch.zeros(2 * 20 * 336 + 1, dtype=torch.bfloat16)[1:]
    assert probes.staged_route(shifted.view(2, 20, 336),
                               (2, 25, 336)) == 'cp.async'


MM_CASES = port_mm.cases()


@pytest.mark.parametrize('name,m,k,n', [c[:4] for c in MM_CASES],
                         ids=[c[0] for c in MM_CASES])
def test_mm_plan_fits_every_case(name, m, k, n):
    """Every product the microbench_mm tool runs has a tile whose panels fit
    in shared memory, whose TMA boxes and strides a tensor map takes under
    the 128-byte swizzle, whose wgmma width is a multiple of 8 up to 256,
    and whose grid covers M and N, K padded to whole 64-deep chunks."""
    plan = probes.mm_plan(m, k, n)
    assert plan.smem <= 232448
    assert plan.bm in (64, 128) and plan.bn in probes.MM_WIDTHS
    assert plan.bn % 8 == 0 and plan.bn <= 256
    # boxes: A 64 k (128 bytes, the swizzle span) by BM rows, B 64 columns
    # by 64 k; at most 256 a dimension; row strides whole 16-byte units
    assert 2 * probes.MM_CHUNK <= 128 and plan.bm <= 256
    assert (2 * k) % 16 == 0 and (2 * n) % 16 == 0
    assert plan.a_chunk == 128 * plan.bm and plan.b_chunk == (
        probes.MM_ATOM * plan.atoms)
    gx, gy = plan.grid
    assert gx * plan.bn >= n > (gx - 1) * plan.bn
    assert gy * plan.bm >= m > (gy - 1) * plan.bm
    assert plan.atoms * 64 >= plan.bn
    assert plan.chunks * probes.MM_CHUNK >= k > (plan.chunks - 1) * 64
    assert plan.ksteps == -(-k // 16)
    # swizzle atoms 1024-byte aligned; barriers after both panels
    for off in (plan.a_chunk, plan.b_chunk, plan.b_off, plan.a_wg):
        assert off % 1024 == 0
    assert plan.bar_off == plan.b_off + plan.chunks * plan.b_chunk
    assert plan.bar_off + 8 * plan.chunks + 1024 <= plan.smem


def test_mm_plan_refuses_rows_a_map_cannot_take():
    """A row of K or N not a whole number of 16-byte units has no tensor
    map; the planner raises rather than pick another route."""
    with pytest.raises(ValueError, match='multiples of 8'):
        probes.mm_plan(70, 30, 16)
    with pytest.raises(ValueError, match='multiples of 8'):
        probes.mm_plan(70, 32, 13)


def test_chip_smoke_mm_tiles_follow_the_planner():
    """``chip_smoke.py`` holds mm_loop's launched tile to a fixed tile at
    each shape of its probes phase; those must be the tiles ``mm_plan``
    picks, so that on the card only a wrong launch fails."""
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = [c[1:4] for c in port_mm.cases()
              if c[0].startswith(('ref ', 'P@W ', 'gate'))][:1] + [
        c[1:4] for c in port_mm.cases() if c[0].startswith(('P@W ', 'gate'))]
    assert sorted(smoke.MM_TILES) == sorted(set(shapes))
    for (m, k, n), tile in smoke.MM_TILES.items():
        plan = probes.mm_plan(m, k, n)
        assert f'{plan.bm}x{plan.bn}' == tile


def swizzled(off):
    """The 128-byte swizzle, written from its definition: within each
    128-byte row the 16-byte unit u moves to u ^ (row % 8)."""
    off = np.asarray(off)
    row, unit, byte = off // 128, off % 128 // 16, off % 16
    return row * 128 + (unit ^ (row % 8)) * 16 + byte


def tma_box(base, rows, lanes):
    """Byte address of element (r, e) of a bf16 box of 128-byte rows that
    the TMA lands at ``base`` (1024-byte aligned) under the swizzle."""
    r, e = np.meshgrid(np.arange(rows), np.arange(lanes), indexing='ij')
    return base + swizzled(128 * r + 2 * e)


def read_k_major(start, sbo, rows, depth):
    """Where wgmma reads element (m, k) of a K-major operand under the
    128-byte swizzle: start + (m / 8) SBO + (m % 8) 128 + 2 k, swizzled
    as an address (PTX ISA, shared-memory matrix layouts)."""
    m, k = np.meshgrid(np.arange(rows), np.arange(depth), indexing='ij')
    return swizzled(start + m // 8 * sbo + m % 8 * 128 + 2 * k)


def read_mn_major(start, lbo, sbo, depth, cols):
    """Where wgmma reads element (k, n) of an MN-major operand under the
    128-byte swizzle: start + (n / 64) LBO + (k / 8) SBO + (k % 8) 128 +
    2 (n % 64), swizzled as an address."""
    k, n = np.meshgrid(np.arange(depth), np.arange(cols), indexing='ij')
    return swizzled(start + n // 64 * lbo + k // 8 * sbo + k % 8 * 128
                    + 2 * (n % 64))


@pytest.mark.parametrize('bm', [64, 128])
@pytest.mark.parametrize('bn', probes.MM_WIDTHS)
def test_mm_descriptors_read_what_the_tma_wrote(bm, bn):
    """The planner's descriptor offsets, read as wgmma reads them, name
    every element of every k-step of the A and B tiles at the address the
    TMA's swizzle put it, and every element of both panels has its own
    address inside its panel.  K = 216 leaves the last chunk part full."""
    k = 216
    plan = probes.mm_tile(bm, bn, 1000, k, 1000)
    a_at = np.array([[plan.a_addr(r, kk) for kk in range(64 * plan.chunks)]
                     for r in range(bm)])
    b_at = np.array([[plan.b_addr(kk, c) for c in range(64 * plan.atoms)]
                     for kk in range(64 * plan.chunks)])
    # distinct, inside the panels, where the TMA's boxes put them
    assert len(np.unique(a_at)) == a_at.size
    assert a_at.min() >= 0 and a_at.max() < plan.b_off
    assert len(np.unique(b_at)) == b_at.size
    assert b_at.min() >= plan.b_off and b_at.max() < plan.bar_off
    for c in range(plan.chunks):
        np.testing.assert_array_equal(
            a_at[:, 64 * c:64 * c + 64], tma_box(c * plan.a_chunk, bm, 64))
        for j in range(plan.atoms):
            np.testing.assert_array_equal(
                b_at[64 * c:64 * c + 64, 64 * j:64 * j + 64],
                tma_box(plan.b_off + c * plan.b_chunk + j * probes.MM_ATOM,
                        64, 64))
    # every k-step's descriptors read the tile's elements there
    for step in range(plan.ksteps):
        for wg in range(bm // 64):
            np.testing.assert_array_equal(
                read_k_major(plan.a_start(wg, step), plan.a_sbo, 64, 16),
                a_at[64 * wg:64 * wg + 64, 16 * step:16 * step + 16])
        np.testing.assert_array_equal(
            read_mn_major(plan.b_start(step), plan.b_lbo, plan.b_sbo, 16,
                          bn),
            b_at[16 * step:16 * step + 16, :bn])
    # 16-byte units of a swizzle atom stay whole and inside the atom
    assert (swizzled(np.arange(0, 1024, 16)) // 1024 == 0).all()


def probe_direct_copies():
    """(label, source shape, output shape, pieces, lanes, source lane) of
    every direct copy the probe tools and ``chip_smoke.py`` make."""
    from shiftnet_tpu_torch.tools import probe_copy_bw, probe_dma_align
    out = [('hbm', (4, 128, 1024), (4, 128, 1024),
            probes.hbm_copy_pieces(4, 40, 40), 1024, 0)]
    t, pp, cb, lp = probe_copy_bw.JAX_SHAPE
    out.append(('permute jax', (t, pp * cb, lp), (t, pp * cb, lp),
                probes.shift_pieces(t, pp, cb, cb // 2), lp, 0))
    for t, c, hw in probe_copy_bw.PORT_SHAPES:
        out.append((f'permute {t}x{c}x{hw}', (t, c, hw), (t, c, hw),
                    probes.shift_pieces(t, 1, c, c // 2), hw, 0))
    for off, lane in probe_dma_align.CASES:
        lanes = 1024 - 8 if lane else 1024
        out.append((f'slice {off} lane {lane}', (1, 128, 1024),
                    (1, 40, lanes), [(0, off, 0, 0, 40)], lanes, lane))
    return out


@pytest.mark.parametrize('label,x_shape,out_shape,pieces,lanes,src_lane',
                         probe_direct_copies(),
                         ids=[c[0] for c in probe_direct_copies()])
def test_copy_grid_covers_every_unit_once(label, x_shape, out_shape, pieces,
                                          lanes, src_lane):
    """The direct copy's grid (``probes.copy_grid``), walked as
    ``block_copy_kernel`` walks it: every unit of the largest piece once,
    one batch a thread, of one unit where a wave of blocks holds the copy
    so (the small copies), else of ``COPY_UNROLL``.  Every probe copy
    moves 16-byte units but the one at a lane offset."""
    x = torch.empty(x_shape, dtype=torch.bfloat16, device='meta')
    out = torch.empty(out_shape, dtype=torch.bfloat16, device='meta')
    table = probes.piece_table('block_copy', x, out_shape, pieces, lanes,
                               src_lane)
    route = probes.copy_route(x, out, table, lanes)
    assert route == ('element' if src_lane % 8 else 'vector')
    units = max(p[4] for p in pieces) * (
        lanes if route == 'element' else lanes // 8)
    blocks, per = probes.copy_grid(units, len(pieces))
    assert per in (1, probes.COPY_UNROLL)
    threads = probes.COPY_THREADS
    j, block, thread = np.meshgrid(np.arange(per), np.arange(blocks),
                                   np.arange(threads), indexing='ij')
    u = (j * blocks + block) * threads + thread
    took = u < units
    np.testing.assert_array_equal(np.bincount(u[took], minlength=units),
                                  np.ones(units, np.int64))
    assert took.sum(axis=0).max() <= per
    # one unit a thread exactly where a wave of such blocks holds the copy
    assert (per == 1) == (-(-units // threads) * len(pieces)
                          <= probes.COPY_WAVE)
    if label.startswith(('hbm', 'slice')):
        assert per == 1


def test_copy_route_takes_the_widest_unit():
    """16-byte units where every row of both sides starts on the 16-byte
    grid, whether or not rows lie back to back, else single elements: a
    row length or a piece off the 16-byte grid."""
    x = torch.empty((2, 48, 1024), dtype=torch.bfloat16, device='meta')

    def route(out_shape, pieces, lanes, src_lane=0):
        out = torch.empty(out_shape, dtype=torch.bfloat16, device='meta')
        return probes.copy_route(x, out, probes.piece_table(
            'block_copy', x, out_shape, pieces, lanes, src_lane), lanes)
    assert route((2, 40, 1024), [(1, 8, 0, 0, 40)], 1024) == 'vector'
    assert route((2, 40, 520), [(1, 8, 0, 0, 40)], 512) == 'vector'
    assert route((2, 40, 1024), [(1, 8, 0, 0, 40)], 1016, 3) == 'element'
    assert route((2, 40, 1020), [(1, 8, 0, 0, 40)], 1016) == 'element'


@pytest.mark.parametrize('name', PORT_TOOLS)
def test_probe_tools_need_cuda(name, monkeypatch):
    """Each probe CLI refuses to measure without a CUDA device."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    tool = importlib.import_module(f'shiftnet_tpu_torch.tools.{name}')
    args = ([],) if name == 'probe_chw' else ()  # not pytest's argv
    with pytest.raises(SystemExit, match='needs a CUDA device'):
        tool.main(*args)
