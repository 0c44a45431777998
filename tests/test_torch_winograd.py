"""The port's Winograd F(2x2, 3x3) convolution (``tpusr_torch/core/
winograd.py``) against ``F.conv2d`` and the JAX package's
``tpusr/core/winograd.py`` on the CPU.

Tolerances: f32 within 1e-4 of ``F.conv2d`` and within 1e-5 of JAX's
``winograd_conv``; bf16 operands within 1e-5 of JAX's bf16 variant; the int8
path's requantised transform and its int32 GEMM results equal JAX's, its
output within 1e-5 relative of JAX's; ``_requant_u4`` rounds half away from
zero over the whole exact range.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from tpusr.core import winograd as jw
from tpusr_torch.bridge import hwio_to_oihw
from tpusr_torch.core import winograd as tw


def _direct(x, k):
    return F.conv2d(x.permute(0, 3, 1, 2), hwio_to_oihw(k),
                    padding=1).permute(0, 2, 3, 1)


def _case(seed, shape=(2, 12, 16, 8), n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, shape[-1], n)) * 0.2).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape,n", [((2, 12, 16, 8), 5), ((1, 8, 6, 16), 32)])
def test_f32_matches_conv2d_and_jax(shape, n):
    x, k = _case(0, shape, n)
    got = tw.winograd_conv(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == (*shape[:3], n)
    torch.testing.assert_close(got, _direct(torch.from_numpy(x),
                                            torch.from_numpy(k)),
                               rtol=1e-4, atol=1e-4)
    want = np.asarray(jw.winograd_conv(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bf16_operands_match_jax():
    x, k = _case(1)
    got = tw.winograd_conv(torch.from_numpy(x), torch.from_numpy(k),
                           gemm_dtype=torch.bfloat16)
    want = np.asarray(jw.winograd_conv(jnp.asarray(x), jnp.asarray(k),
                                       gemm_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_transform_weights_matches_jax():
    _, k = _case(2, (1, 4, 4, 6), 7)
    np.testing.assert_allclose(tw.transform_weights(torch.from_numpy(k)).numpy(),
                               np.asarray(jw.transform_weights(k)),
                               rtol=0, atol=1e-6)


def test_int8_gemm_results_and_output_match_jax():
    rng = np.random.default_rng(2)
    s_x = 0.05
    x_q = rng.integers(-127, 128, (2, 16, 16, 16)).astype(np.int8)
    k = rng.standard_normal((3, 3, 16, 8)).astype(np.float32) * 0.1
    wq, rescale = tw.quantize_winograd_weights(torch.from_numpy(k),
                                               tw.int8_u_scales(s_x))
    jwq, jrs = jw.quantize_winograd_weights(k, jw.int8_u_scales(s_x))
    # quantised by torch ops where the kernel lies, in JAX's dtypes
    assert wq.dtype == torch.int8 and rescale.dtype == torch.float32
    assert wq.device == rescale.device == torch.device("cpu")
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_allclose(rescale.numpy(), np.asarray(jrs), rtol=1e-6)
    np.testing.assert_array_equal(tw.int8_u_scales(s_x), jw.int8_u_scales(s_x))
    # the requantised input transform and each position's int32 GEMM
    xt = torch.from_numpy(x_q)
    u = [tw._requant_u4(t) for t in
         tw._input_transform(tw._tiles(xt), torch.int32)]
    ju = [jw._requant_u4(t) for t in jw._input_transform(
        jw._tile_slices(jnp.pad(jnp.asarray(x_q), ((0, 0), (1, 1), (1, 1),
                                                   (0, 0))), 8, 8), jnp.int32)]
    for p in range(16):
        np.testing.assert_array_equal(u[p].numpy(), np.asarray(ju[p]))
        got = tw._int8_gemm(u[p].reshape(-1, 16), wq[p])
        want = jax.lax.dot_general(ju[p].reshape(-1, 16), jwq[p],
                                   (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tw.winograd_conv_int8(xt, s_x, wq, rescale)
    want = np.asarray(jw.winograd_conv_int8(jnp.asarray(x_q), s_x, jwq, jrs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # and it tracks the f32 conv as JAX's test holds it
    y_f32 = _direct(xt.float() * s_x, torch.from_numpy(k)).numpy()
    assert np.abs(got.numpy() - y_f32).max() < 0.05 * np.abs(y_f32).max()


def test_requant_rounds_half_away_from_zero():
    t = torch.arange(-508, 509, dtype=torch.int32)
    got = tw._requant_u4(t)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jw._requant_u4(jnp.asarray(t.numpy()))))
    np.testing.assert_array_equal(
        got.numpy(), np.clip(np.sign(t.numpy()) * ((np.abs(t.numpy()) + 2) // 4),
                             -127, 127))
    for tv, rv in ((-4, -1), (-1, 0), (-2, -1), (-6, -2), (2, 1), (6, 2)):
        assert int(tw._requant_u4(torch.tensor(tv, dtype=torch.int32))) == rv


def test_odd_sizes_raise():
    x, k = _case(4, (1, 11, 10, 4), 4)
    with pytest.raises(ValueError, match="even"):
        tw.winograd_conv(torch.from_numpy(x), torch.from_numpy(k))
    wq, rescale = tw.quantize_winograd_weights(torch.from_numpy(k),
                                               tw.int8_u_scales(0.1))
    with pytest.raises(ValueError, match="even"):
        tw.winograd_conv_int8(torch.zeros((1, 10, 11, 4), dtype=torch.int8),
                              0.1, wq, rescale)
