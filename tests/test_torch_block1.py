"""K3 of the port (tpusr_torch/models/block1.py) against the JAX package's
block 1 on the CPU: the plain twin equals ``block1_reference`` through
``frames_to_pooled`` bit for bit, at the kernel's 96/48 and, through
quant.py's own convs, at the CPU tests' 32/16; and the per-patch int8
classifier that runs block 1 through K3 equals the all-K1 path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import to_numpy, vgg16_tree
from tpusr.models import quant as jq
from tpusr.models.pallas_vgg import (block1_reference, build_img36_from_image,
                                     extract_patches_reference,
                                     frames_to_pooled, make_block1_fn)
from tpusr.models.pallas_vgg import grid_counts as jax_grid_counts
from tpusr_torch.bridge import qtree_from_flax
from tpusr_torch.models import block1
from tpusr_torch.models import quant as tq

_DN = ("NHWC", "HWIO", "NHWC")


def _block1_tree(rng, width=64):
    """int8 block-1 layers as the Pallas tests make them (numpy)."""
    q = {"layers": {}}
    for name, ci in (("block1_conv1", 3), ("block1_conv2", width)):
        q["layers"][name] = {
            "kernel_q": rng.integers(-127, 128, (3, 3, ci, width)).astype(np.int8),
            "rescale": rng.random(width).astype(np.float32) * 1e-3,
            "bias_over_out": rng.random(width).astype(np.float32) * 5 + 0.5}
    return q


def _torch_tree(q):
    return {"layers": {n: {k: torch.from_numpy(v) for k, v in layer.items()}
                       for n, layer in q["layers"].items()}}


def _jax_block1_pooled(q, patches):
    """Block 1 of quant.int8_backbone on extracted patches (the XLA ops of
    block1_reference without its 96/48 frame layout)."""
    x = patches
    for name in ("block1_conv1", "block1_conv2"):
        layer = q["layers"][name]
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(layer["kernel_q"]), (1, 1), "SAME",
            dimension_numbers=_DN, preferred_element_type=jnp.int32)
        yf = y.astype(jnp.float32) * layer["rescale"] + layer["bias_over_out"]
        x = jnp.clip(yf, 0.0, 127.0).astype(jnp.int8)
    return jax.lax.reduce_window(x, jnp.int8(-128), jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


@pytest.mark.parametrize("hw", [(128, 128), (130, 170)])
def test_block1_plain_bit_exact_vs_block1_reference(hw):
    rng = np.random.default_rng(sum(hw))
    q = _block1_tree(rng)
    img = rng.integers(-127, 128, (1, *hw, 3)).astype(np.int8)
    n_pr, n_pc = jax_grid_counts(*hw)
    assert block1.grid_counts(*hw) == (n_pr, n_pc)
    want = np.asarray(frames_to_pooled(block1_reference(
        q, extract_patches_reference(jnp.asarray(img), n_pr, n_pc))))
    block1.reset_launch_counts()
    got = block1.block1_int8(_torch_tree(q), torch.from_numpy(img)).numpy()
    assert got.shape == (n_pr * n_pc, 48, 48, 64)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 16                 # not collapsed
    assert block1.LAUNCHES["block1_int8"] == 0       # CPU: the plain twin


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 37, 45)])
def test_block1_plain_bit_exact_at_32_16(shape):
    rng = np.random.default_rng(sum(shape))
    q = _block1_tree(rng)
    img = rng.integers(-127, 128, (*shape, 3)).astype(np.int8)
    n_pr, n_pc = jax_grid_counts(*shape[1:], patch=32, stride=16)
    patches = extract_patches_reference(jnp.asarray(img), n_pr, n_pc, 32, 16)
    want = np.asarray(_jax_block1_pooled(q, patches))
    got = block1.block1_int8(_torch_tree(q), torch.from_numpy(img), 32, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own patch extraction is the reference's
    np.testing.assert_array_equal(
        block1.extract_patches_reference(torch.from_numpy(img), 32, 16).numpy(),
        np.asarray(patches))


@pytest.mark.slow  # interpret-mode Pallas kernel (~1 min on the CPU)
def test_block1_plain_bit_exact_vs_pallas_kernel():
    rng = np.random.default_rng(3)
    q = _block1_tree(rng)
    img = rng.integers(-127, 128, (2, 128, 128, 3)).astype(np.int8)
    frames = jax.jit(make_block1_fn(jax.tree.map(jnp.asarray, q), 2, 2,
                                    interpret=True))(
        build_img36_from_image(jnp.asarray(img), 2, 2))
    got = block1.block1_int8(_torch_tree(q), torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(frames_to_pooled(frames)))


def test_per_patch_int8_probs_equals_all_k1_path_and_jax():
    """Block 1 through K3 (its twin here), blocks 2-5 through K1: the same
    probabilities as quantized_vgg16_apply on the extracted patches, and
    JAX's per-patch path within 1e-6, on a narrow VGG16 tree."""
    rng = np.random.default_rng(21)
    params = vgg16_tree(rng)
    calib = rng.random((4, 32, 32, 3), dtype=np.float32)
    qj = to_numpy(jq.quantize_vgg16(params, jq.calibrate_vgg16(params, calib)))
    q = qtree_from_flax(qj, device="cpu")
    images = rng.random((2, 48, 56, 3), dtype=np.float32)
    xq = tq.quantize_input(q, torch.from_numpy(images))
    got = tq.per_patch_int8_probs(q, xq, 32, 16)
    n_pr, n_pc = block1.grid_counts(48, 56, 32, 16)
    assert got.shape == (2, n_pr * n_pc, 2)
    flat = block1.extract_patches_reference(xq, 32, 16)
    want = tq.quantized_vgg16_apply(q, flat).reshape(got.shape)
    assert torch.equal(got, want)
    # float images are quantized first
    assert torch.equal(tq.per_patch_int8_probs(q, torch.from_numpy(images),
                                               32, 16), got)
    xj = jq.quantize_input(qj, jnp.asarray(images))
    patches = extract_patches_reference(xj, n_pr, n_pc, 32, 16)
    probs_j = np.asarray(jq.quantized_vgg16_apply(qj, patches))
    np.testing.assert_allclose(got.reshape(-1, 2).numpy(), probs_j, atol=1e-6,
                               rtol=0)


def test_block1_refuses_what_it_does_not_take():
    q = _torch_tree(_block1_tree(np.random.default_rng(0), width=8))
    img = torch.zeros((1, 32, 32, 3), dtype=torch.int8)
    assert block1.block1_int8(q, img, 32, 16).shape == (4, 16, 16, 8)
    with pytest.raises(TypeError):
        block1.block1_int8(q, img.float(), 32, 16)
    with pytest.raises(ValueError, match="even"):
        block1.block1_int8(q, img, 31, 16)
    with pytest.raises(ValueError, match="kernel"):
        block1.block1_int8({"layers": {**q["layers"], "block1_conv2":
                                       _torch_tree(_block1_tree(
                                           np.random.default_rng(1)))
                                       ["layers"]["block1_conv2"]}}, img)
