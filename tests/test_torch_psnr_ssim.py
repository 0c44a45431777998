"""The trainers' PSNR and SSIM in the port (tpusr_torch/metrics/image.py)
against tpusr/metrics/image.py (tf.image parity) on seeded numpy pairs,
batched and unbatched. Tolerance: rtol 1e-5, atol 1e-6 (float32 filters
summed in another order than XLA's)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusr.metrics import image as jm
from tpusr_torch.metrics import image as tm

RTOL, ATOL = 1e-5, 1e-6


def _pair(seed, shape, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape).astype(np.float32), 0, 1)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (2, 3, 16, 20, 1),
                                   (24, 17, 3)])
def test_psnr_matches_jax(shape):
    a, b = _pair(sum(shape), shape)
    want = np.asarray(jm.psnr(jnp.asarray(a), jnp.asarray(b)))
    got = tm.psnr(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # max_val 255 on the same pair scaled
    want = np.asarray(jm.psnr(jnp.asarray(a * 255), jnp.asarray(b * 255), 255.0))
    got = tm.psnr(torch.from_numpy(a * 255), torch.from_numpy(b * 255), 255.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,noise", [((4, 32, 32, 3), 0.1),
                                         ((2, 3, 24, 20, 1), 0.3),
                                         ((16, 16, 3), 0.05),
                                         ((3, 11, 11, 2), 0.2)])
def test_ssim_matches_jax(shape, noise):
    a, b = _pair(7 + sum(shape), shape, noise)
    want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = tm.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == want.shape      # () for an unbatched pair
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ssim_options_match_jax():
    a, b = _pair(3, (2, 20, 20, 3))
    kw = dict(max_val=2.0, filter_size=7, filter_sigma=1.0, k1=0.02, k2=0.05)
    want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b), **kw))
    got = tm.ssim(torch.from_numpy(a), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gauss_window_equals_jax_and_is_cast_from_float64():
    w = tm._fspecial_gauss(11, 1.5)
    assert w.dtype == np.float64
    np.testing.assert_array_equal(w, jm._fspecial_gauss(11, 1.5))
    x = np.random.default_rng(0).random((2, 15, 13, 3), dtype=np.float32)
    got = tm._filter2_valid(torch.from_numpy(x), w)
    want = np.asarray(jm._filter2_valid(jnp.asarray(x), w))
    assert tuple(got.shape) == want.shape == (2, 5, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_identical_images_give_ssim_one_and_infinite_psnr():
    a, _ = _pair(5, (3, 24, 24, 3))
    t = torch.from_numpy(a)
    np.testing.assert_allclose(tm.ssim(t, t).numpy(), 1.0, rtol=0, atol=1e-6)
    assert torch.isinf(tm.psnr(t, t)).all()
    # integer inputs are taken as float32, as JAX's astype does
    u8 = (a * 255).astype(np.uint8)
    want = np.asarray(jm.ssim(jnp.asarray(u8), jnp.asarray(u8[:, ::-1]), 255.0))
    got = tm.ssim(torch.from_numpy(u8), torch.from_numpy(u8[:, ::-1].copy()), 255.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_an_image_smaller_than_the_window_gives_nan_as_jax():
    a, b = _pair(8, (2, 8, 12, 3))
    want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = tm.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert np.isnan(want).all() and torch.isnan(got).all()
    assert tuple(got.shape) == want.shape
