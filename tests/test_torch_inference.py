"""Patch SR inference in the port against the JAX package: overlap-add and
its coverage weights, ``super_resolve_image`` with a narrow EDSR,
``srcnn_super_resolve``, the metrics fields and the refused ``mesh``.

Inputs are made with numpy from a seed; the nets' flax trees go to JAX as
they are and to the port through ``tpusr_torch.bridge``. Tolerances:
overlap-add 1e-6 (the sums run in another order than XLA's), SR 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import edsr_tree, to_numpy
from tpusr.core import patches as jax_patches
from tpusr.models import SRCNN as JaxSRCNN
from tpusr.pipeline import inference as jax_inf
from tpusr_torch.bridge import edsr_from_flax, srcnn_from_flax
from tpusr_torch.core import conv3x3
from tpusr_torch.core.patches import (overlap_add, overlap_weight,
                                      patch_grid_size)
from tpusr_torch.pipeline import inference

OVERLAP_ATOL = 1e-6
SR_ATOL = 1e-5


@pytest.mark.parametrize("grid,patch,stride", [
    ((4, 6), 24, 12),      # stride | patch: JAX's block path
    ((3, 3), 48, 24),
    ((5, 4), 33, 14),      # JAX's scan path (tests/test_pad_patches.py:83)
    ((2, 7), 9, 4)])
@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("crop", [None, "odd"])
def test_overlap_add_matches_jax(grid, patch, stride, average, crop):
    nh, nw = grid
    rng = np.random.default_rng(nh * 100 + patch + stride)
    p = rng.standard_normal((nh * nw, patch, patch, 3)).astype(np.float32)
    out_h, out_w = (nh - 1) * stride + patch, (nw - 1) * stride + patch
    crop_hw = None if crop is None else (out_h - 3, out_w - 5)
    want = np.asarray(jax_patches.overlap_add(jnp.asarray(p), grid, stride,
                                              crop_hw=crop_hw,
                                              average=average))
    got = overlap_add(torch.from_numpy(p), grid, stride, crop_hw=crop_hw,
                      average=average).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=OVERLAP_ATOL, rtol=0)


@pytest.mark.parametrize("grid,patch,stride", [((4, 6), 24, 12),
                                                ((5, 4), 33, 14)])
def test_overlap_weight_equals_jax(grid, patch, stride):
    np.testing.assert_array_equal(
        overlap_weight(*grid, patch, stride),
        jax_patches.overlap_weight(*grid, patch, stride))


def test_overlap_add_is_zero_where_nothing_covers_a_pixel():
    # a stride wider than the patch leaves gaps: 0 there, not nan
    p = torch.ones((4, 3, 3, 2))
    got = overlap_add(p, (2, 2), 5)
    want = np.asarray(jax_patches.overlap_add(jnp.ones((4, 3, 3, 2)), (2, 2), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3, 3].abs().sum() == 0 and got[0, 0].sum() == 2


def test_overlap_add_refuses_a_wrong_patch_count():
    with pytest.raises(ValueError, match="patch count"):
        overlap_add(torch.zeros((5, 4, 4, 3)), (2, 2), 2)


@pytest.mark.parametrize("scale,patch,stride,hw", [(2, 8, 4, (20, 18)),
                                                    (4, 8, 4, (13, 16)),
                                                    (2, 9, 5, (17, 22))])
def test_super_resolve_image_matches_jax(scale, patch, stride, hw):
    rng = np.random.default_rng(scale + patch)
    m, params = edsr_tree(rng, scale, num_res_blocks=1, num_filters=8)
    lr = rng.random((*hw, 3), dtype=np.float32)
    want, want_m = jax_inf.super_resolve_image(
        lambda p: m.apply({"params": params}, p), lr, patch_size_lr=patch,
        stride=stride, scale=scale)
    model = edsr_from_flax(params, scale, device="cpu")
    conv3x3.reset_launch_counts()
    got, metrics = inference.super_resolve_image(
        model, lr, patch_size_lr=patch, stride=stride, scale=scale)
    assert got.device.type == "cpu" and got.shape == (hw[0] * scale,
                                                      hw[1] * scale, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SR_ATOL,
                               rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert set(metrics) == set(want_m)
    assert conv3x3.LAUNCHES["conv3x3_bias_act"] == 0   # the twin on the CPU


def test_srcnn_super_resolve_matches_jax():
    rng = np.random.default_rng(7)
    net = JaxSRCNN(f1=16, f2=8)
    params = to_numpy(net.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 8, 8, 3)))["params"])
    params = jax.tree.map(
        lambda a: a + (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
        if a.ndim == 1 else a, params)
    lr = rng.random((11, 13, 3), dtype=np.float32)
    want, _ = jax_inf.srcnn_super_resolve(
        lambda p: net.apply({"params": params}, p), lr, 30, 34,
        patch_size=12, stride=5)
    model = srcnn_from_flax(params, device="cpu")
    got, metrics = inference.srcnn_super_resolve(model, lr, 30, 34,
                                                 patch_size=12, stride=5)
    assert got.shape == (30, 34, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SR_ATOL,
                               rtol=0)
    assert metrics["time_sec"] > 0


def test_timed_call_keeps_the_reference_fields():
    x = torch.ones(3)
    out, metrics = inference._timed_call(lambda t: t * 2, x)
    assert torch.equal(out, torch.full((3,), 2.0))
    _, jax_metrics = jax_inf._timed_call(lambda t: t * 2, jnp.ones(3))
    assert set(metrics) == set(jax_metrics) == {
        "time_sec", "gpu_mean_current_mb", "gpu_peak_mb"}
    assert metrics["time_sec"] >= 0
    # torch keeps no allocator statistics for the CPU
    assert metrics["gpu_mean_current_mb"] is None
    assert metrics["gpu_peak_mb"] is None


def test_largest_divisor_matches_jax():
    for n, cap in ((64, 16), (100, 30), (97, 50), (4096, 4096), (12, 1)):
        assert (inference._largest_divisor_at_most(n, cap)
                == jax_inf._largest_divisor_at_most(n, cap))


def test_full_image_sr_refuses_a_mesh_naming_the_roadmap_item():
    # the mesh path is ported (tests/test_torch_dist_spatial.py); what is
    # not a DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        inference.super_resolve_full_image(object(), np.zeros((4, 4, 3)),
                                           mesh=object())


def test_sr_inference_fn_grid_matches_jax_padding():
    # the patch grid of a padded LR image, as the JAX function derives it
    from tpusr.core.pad import pad_amounts as jax_pad_amounts
    from tpusr_torch.core.pad import pad_amounts
    for h, w, p, s in ((20, 18, 8, 4), (128, 128, 48, 24), (17, 22, 9, 5)):
        assert pad_amounts(h, w, p, s) == jax_pad_amounts(h, w, p, s)
        ph, pw = pad_amounts(h, w, p, s)
        assert patch_grid_size(h + ph, w + pw, p, s) == \
            jax_patches.patch_grid_size(h + ph, w + pw, p, s)
