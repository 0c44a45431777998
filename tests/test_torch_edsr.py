"""EDSR and its fused-tail forward in the port against the JAX package:
pixel shuffle, the bridged model, the composed tail kernel and the fused
forward with its border band."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import edsr_tree
from tpusr.models.edsr_fast import fused_tail_kernel as jax_fused_tail_kernel
from tpusr.models.edsr_fast import make_fused_sr_apply as jax_make_fused
from tpusr.models.layers import pixel_shuffle as jax_pixel_shuffle
from tpusr_torch.bridge import edsr_from_flax
from tpusr_torch.core import conv3x3
from tpusr_torch.models.edsr_fast import fused_tail_kernel, make_fused_sr_apply
from tpusr_torch.models.layers import pixel_shuffle


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_is_dcr_not_torch_crd(r):
    x = np.random.default_rng(r).standard_normal((2, 3, 4, 3 * r * r)).astype(np.float32)
    got = pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pixel_shuffle(jnp.asarray(x), r)))
    crd = torch.nn.PixelShuffle(r)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.array_equal(crd.permute(0, 2, 3, 1).numpy(), got)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_bridged_edsr_matches_flax_apply(scale):
    rng = np.random.default_rng(scale)
    m, params = edsr_tree(rng, scale)
    x = rng.random((2, 12, 10, 3), dtype=np.float32)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    model = edsr_from_flax(params, scale, device="cpu")
    conv3x3.reset_launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 12 * scale, 10 * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert conv3x3.LAUNCHES["conv3x3_bias_act"] == 0


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_fused_tail_kernel_matches_jax(scale):
    _, params = edsr_tree(np.random.default_rng(10 + scale), scale)
    w_j, b_j, pad_j = jax_fused_tail_kernel(params, scale)
    w, b, pad = fused_tail_kernel(edsr_from_flax(params, scale, device="cpu"))
    assert pad == pad_j and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale", [2, 4])
def test_fused_sr_apply_matches_jax_including_border_band(scale):
    rng = np.random.default_rng(20 + scale)
    m, params = edsr_tree(rng, scale)
    # 16x16 LR: the 3-cell border band and the interior are both present
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    fn_j, s_j = jax_make_fused(params, scale, dtype=jnp.float32)
    want = np.asarray(fn_j(jnp.asarray(x)))
    model = edsr_from_flax(params, scale, device="cpu")
    fn, s = make_fused_sr_apply(model)
    with torch.inference_mode():
        got = fn(torch.from_numpy(x))
        full = model(torch.from_numpy(x))
    assert s == s_j and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # and the identity the fused forward exists for
    np.testing.assert_allclose(pixel_shuffle(got, s).numpy(), full.numpy(),
                               atol=1e-5, rtol=0)
    # the band matters: the composed conv alone is wrong there
    w_eff, b_eff, pad = fused_tail_kernel(model)
    with torch.inference_mode():
        y = model.body_out(torch.from_numpy(x))
        z = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2),
                                       w_eff.permute(3, 2, 0, 1), padding=pad)
        z = (z.permute(0, 2, 3, 1) + b_eff).clamp(0.0, 1.0).numpy()
    assert np.abs(z[:, :pad] - want[:, :pad]).max() > 1e-3
    np.testing.assert_allclose(z[:, pad:-pad, pad:-pad],
                               want[:, pad:-pad, pad:-pad], atol=1e-5, rtol=0)
