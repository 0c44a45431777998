"""The port's uncomposed polyphase EDSR path (``tpusr_torch/models/
edsr_fast.py``: ``polyphase_tail_kernel``, ``dualize_conv_kernel``,
``_conv_dual``, ``edsr_forward_poly``, ``make_poly_sr_apply``) against the
JAX package's and the port's own ``EDSR`` forward, on a 2-block, 8-filter
EDSR on the CPU.

Tolerances: the refactored kernels equal JAX's exactly; the dual-pixel conv
equals the SAME conv exactly on integer data (as ``tests/test_edsr_fast.py``
holds it) and within 1e-5 on float data; ``pixel_shuffle(poly)`` within
1e-5 of ``EDSR.forward`` and of JAX's ``make_poly_sr_apply(dtype=float32)``
on the same weights; bf16 within a PSNR of 35 dB of f32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from test_torch_fixtures import edsr_tree
from tpusr.models import edsr_fast as jfast
from tpusr.models.layers import pixel_shuffle as jax_pixel_shuffle
from tpusr_torch.bridge import edsr_from_flax, hwio_to_oihw
from tpusr_torch.models import edsr_fast as tfast
from tpusr_torch.models.layers import pixel_shuffle

ATOL = 1e-5


@pytest.mark.parametrize("r", [2, 3])
def test_polyphase_tail_kernel_equals_jax(r):
    w = np.random.default_rng(r).standard_normal((3, 3, 8, 3)).astype(np.float32)
    got = tfast.polyphase_tail_kernel(torch.from_numpy(w), r)
    assert got.shape == (3, 3, 8 * r * r, 3 * r * r)
    np.testing.assert_array_equal(got.numpy(), jfast.polyphase_tail_kernel(w, r))
    with pytest.raises(ValueError, match="3x3"):
        tfast.polyphase_tail_kernel(torch.zeros(5, 5, 2, 2), r)


def test_dualize_conv_kernel_exact():
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (2, 10, 12, 8)).astype(np.float32)
    k = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.float32)
    k2 = tfast.dualize_conv_kernel(torch.from_numpy(k))
    np.testing.assert_array_equal(k2.numpy(), jfast.dualize_conv_kernel(k))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   hwio_to_oihw(torch.from_numpy(k)), padding=1).permute(0, 2, 3, 1)
    got = tfast._conv_dual(k2, torch.zeros(16), torch.from_numpy(x))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # float data with a bias, against the SAME conv and JAX's _conv_dual
    xf = rng.random((2, 6, 8, 8), dtype=np.float32)
    kf = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    got = tfast._conv_dual(tfast.dualize_conv_kernel(torch.from_numpy(kf)),
                           torch.from_numpy(b), torch.from_numpy(xf))
    ref = F.conv2d(torch.from_numpy(xf).permute(0, 3, 1, 2),
                   hwio_to_oihw(torch.from_numpy(kf)), torch.from_numpy(b),
                   padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
    want = jfast._conv_dual(jnp.asarray(jfast.dualize_conv_kernel(kf)),
                            jnp.asarray(b), jnp.asarray(xf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("scale,hw", [(2, 12), (3, 10), (4, 12)])
def test_poly_path_equals_edsr_forward_and_jax(scale, hw):
    _, params = edsr_tree(np.random.default_rng(scale), scale)
    edsr = edsr_from_flax(params, scale, device="cpu")
    x = np.random.default_rng(10 + scale).random((2, hw, hw, 3), np.float32)
    xt = torch.from_numpy(x)
    fn, r = tfast.make_poly_sr_apply(edsr, dtype=torch.float32)
    assert r == (scale if scale in (2, 3) else 2)
    with torch.no_grad():
        poly = fn(xt)
        sr = edsr(xt)
        direct, r2 = tfast.edsr_forward_poly(edsr, xt)
    assert poly.shape == (2, hw * scale // r, hw * scale // r, 3 * r * r)
    assert r2 == r and poly.dtype == torch.float32
    torch.testing.assert_close(direct, poly, rtol=0, atol=0)
    torch.testing.assert_close(pixel_shuffle(poly, r), sr, rtol=0, atol=ATOL)
    jfn, jr = jfast.make_poly_sr_apply(params, scale, dtype=jnp.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    assert jr == r
    np.testing.assert_allclose(poly.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pixel_shuffle(poly, r).numpy(),
                               np.asarray(jax_pixel_shuffle(want, r)),
                               rtol=0, atol=ATOL)


def test_bf16_is_the_default_and_close_to_f32():
    _, params = edsr_tree(np.random.default_rng(4), 4)
    edsr = edsr_from_flax(params, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).random((2, 12, 12, 3),
                                                         np.float32))
    fn, r = tfast.make_poly_sr_apply(edsr)
    f32, _ = tfast.make_poly_sr_apply(edsr, dtype=torch.float32)
    with torch.no_grad():
        y16, y32 = fn(x), f32(x)
    assert y16.dtype == torch.bfloat16 and torch.isfinite(y16.float()).all()
    mse = float(((y16.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-20)) >= 35.0
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfast.make_poly_sr_apply(edsr, dtype=torch.float16)
