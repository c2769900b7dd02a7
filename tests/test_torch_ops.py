"""The port's shift, norm and resize ops against the reference fixtures and
the JAX package's ops (``shiftnet_tpu/ops``), on the CPU.

The fixtures come from the reference PyTorch code in NCHW, the port's own
layout; the JAX ops take NHWC.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from shiftnet_tpu.ops import norm as jnorm
from shiftnet_tpu.ops import resize as jresize
from shiftnet_tpu.ops import shift as jshift
from shiftnet_tpu_torch.ops import norm, resize, shift


def to_nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def to_nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def norm_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.std(b)


@pytest.mark.parametrize('fixture,number,patch', [
    ('ops_shift_big', 5, True),    # deblur_plus width 80, boundary patch
    ('ops_shift_small', 4, False),  # deblur_small width 64, circular roll
])
@pytest.mark.parametrize('reverse', [False, True])
def test_gsts_matches_reference_bit_exact(fixture, number, patch, reverse):
    fx = load_fixture(fixture)
    y, hw = shift.gsts(torch.from_numpy(fx['x']), number, reverse=reverse,
                       boundary_patch=patch)
    got = torch.cat([y, hw], dim=1).numpy()
    np.testing.assert_array_equal(got, fx['rev' if reverse else 'fwd'])
    want_jax = jshift.gsts(jnp.asarray(to_nhwc(fx['x'])), number,
                           reverse=reverse, boundary_patch=patch)
    np.testing.assert_array_equal(got, to_nchw(want_jax))


def test_grouped_spatial_shift_bit_exact():
    fx = load_fixture('ops_shift_big')
    got = shift.grouped_spatial_shift(torch.from_numpy(fx['sp_in']), 5)
    np.testing.assert_array_equal(got.numpy(), fx['sp_out'])
    want = jshift.grouped_spatial_shift(jnp.asarray(to_nhwc(fx['sp_in'])), 5)
    np.testing.assert_array_equal(got.numpy(), to_nchw(want))


@pytest.mark.parametrize('number', [1, 2, 3, 5])
def test_shift_dir_table_matches_jax(number):
    assert shift.shift_dir_table(number) == jshift.shift_dir_table(number)


@pytest.mark.parametrize('h,w', [(4, 6), (12, 20)])  # shifts wider than H
def test_grouped_spatial_shift_small_extents(h, w):
    x = np.random.default_rng(0).standard_normal((2, 24, h, w)).astype(
        np.float32)
    got = shift.grouped_spatial_shift(torch.from_numpy(x), 3)
    want = jshift.grouped_spatial_shift(jnp.asarray(to_nhwc(x)), 3)
    np.testing.assert_array_equal(got.numpy(), to_nchw(want))


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('patch', [False, True])
def test_temporal_channel_shift_matches_jax(reverse, patch):
    x = np.random.default_rng(1).standard_normal((4, 10, 3, 5)).astype(
        np.float32)
    got = shift.temporal_channel_shift(torch.from_numpy(x), reverse=reverse,
                                       boundary_patch=patch)
    want = jshift.temporal_channel_shift(jnp.asarray(to_nhwc(x)),
                                         reverse=reverse,
                                         boundary_patch=patch)
    np.testing.assert_array_equal(got.numpy(), to_nchw(want))


def test_layer_norm_2d_matches_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((3, 12, 5, 7)) + 1).astype(np.float32)
    wt = rng.standard_normal(12).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    got = norm.layer_norm_2d(torch.from_numpy(x), torch.from_numpy(wt),
                             torch.from_numpy(b))
    want = jnorm.layer_norm_2d(jnp.asarray(to_nhwc(x)), jnp.asarray(wt),
                               jnp.asarray(b))
    assert norm_err(got.numpy(), to_nchw(want)) < 1e-5


def test_layer_norm_2d_bf16_keeps_dtype():
    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    y = norm.layer_norm_2d(x.bfloat16(), torch.ones(8), torch.zeros(8))
    assert y.dtype == torch.bfloat16
    assert norm_err(y.float().numpy(),
                    norm.layer_norm_2d(x, torch.ones(8),
                                       torch.zeros(8)).numpy()) < 2e-2


def test_resize_matches_reference_and_jax():
    fx = load_fixture('ops_resize')
    up = resize.bilinear_up2x(torch.from_numpy(fx['up_in'])).numpy()
    np.testing.assert_allclose(up, fx['up_out'], atol=1e-6, rtol=0)
    up_jax = jresize.bilinear_up2x(jnp.asarray(to_nhwc(fx['up_in'])))
    np.testing.assert_allclose(up, to_nchw(up_jax), atol=1e-6, rtol=0)
    ps = resize.pixel_shuffle(torch.from_numpy(fx['ps_in']), 2).numpy()
    np.testing.assert_array_equal(ps, fx['ps_out'])
    ps_jax = jresize.pixel_shuffle(jnp.asarray(to_nhwc(fx['ps_in'])), 2)
    np.testing.assert_array_equal(ps, to_nchw(ps_jax))
