"""ESRGAN in the port against the JAX package: self-attention (dense and
blockwise), the generator, the spectral-norm discriminator with its
power-iteration step, the parameter counts, and full-image and patch SR with
the generator.

Inputs are made with numpy from a seed; the flax trees go to JAX as they are
and to the port through ``tpusr_torch.bridge``. Tolerances: attention 2e-5
(as ``tests/test_blockwise_attention.py``), the generator and its SR 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import to_numpy
from tpusr.config import ESRGANConfig
from tpusr.models.esrgan import ESRGANDiscriminator as JaxDisc
from tpusr.models.esrgan import ESRGANGenerator as JaxGen
from tpusr.models.layers import SelfAttention as JaxSelfAttention
from tpusr.pipeline import inference as jax_inf
from tpusr_torch import config as port_config
from tpusr_torch.bridge import (esrgan_discriminator_from_flax,
                                esrgan_generator_from_flax)
from tpusr_torch.core import conv3x3
from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
from tpusr_torch.models.init import ParamRng
from tpusr_torch.models.layers import Conv1x1, SelfAttention
from tpusr_torch.pipeline import inference

ATTN_ATOL = 2e-5
GEN_ATOL = 1e-5


def _attention_from_flax(params, channels, block_size=None):
    layer = SelfAttention(channels, block_size=block_size,
                          rng=ParamRng(0, device="cpu"))
    sd = {f"{name}.{leaf}": torch.from_numpy(
              np.array(v)[0, 0] if leaf == "kernel" else np.array(v))
          for name, p in params.items() for leaf, v in p.items()}
    layer.load_state_dict(sd, strict=True)
    return layer


def _random_biases(tree, rng):
    """``tree`` with every bias drawn at random (flax initialises them to
    zero, which would leave the bias paths untested)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(np.shape(v)) * 0.05).astype(np.float32)
                if k == "bias" else _random_biases(v, rng)
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def attention_case():
    rng = np.random.default_rng(0)
    x = rng.random((2, 8, 8, 16), dtype=np.float32)
    v = JaxSelfAttention(channels=16).init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))
    params = _random_biases(to_numpy(v["params"]), rng)
    want = np.asarray(JaxSelfAttention(channels=16).apply(
        {"params": params}, jnp.asarray(x)))
    return x, params, want


@pytest.mark.parametrize("block", [None, 8, 16, 32, 64])
def test_self_attention_matches_jax_dense_and_blockwise(attention_case, block):
    x, params, want_dense = attention_case
    want = np.asarray(JaxSelfAttention(channels=16, block_size=block).apply(
        {"params": params}, jnp.asarray(x)))
    got = _attention_from_flax(params, 16, block)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATTN_ATOL,
                               rtol=ATTN_ATOL)
    np.testing.assert_allclose(got.detach().numpy(), want_dense,
                               atol=ATTN_ATOL, rtol=ATTN_ATOL)


def test_self_attention_dense_path_at_hw_within_the_block(attention_case):
    x, params, want = attention_case
    layer = _attention_from_flax(params, 16, block_size=4096)  # HW = 64
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    # attention_fn takes precedence over the block size: a zero attention
    # output leaves x plus the v projection's bias
    override = layer.attend(torch.from_numpy(x), 8,
                            lambda gg, ff, hf: torch.zeros_like(hf))
    np.testing.assert_allclose(override.detach().numpy(),
                               x + layer.v.bias.numpy(), atol=1e-6, rtol=0)


def test_self_attention_refuses_a_block_that_does_not_divide_hw(attention_case):
    x, params, _ = attention_case
    with pytest.raises(ValueError, match="divide"):
        _attention_from_flax(params, 16, block_size=5)(torch.from_numpy(x))


def test_conv1x1_is_flax_1x1_conv():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1, 8, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + b
    conv = Conv1x1(8, 4, ParamRng(0, device="cpu"))
    conv.load_state_dict({"kernel": torch.from_numpy(k[0, 0]),
                          "bias": torch.from_numpy(b)})
    np.testing.assert_allclose(conv(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)


def _generator_case(scale, seed=0, growth=4, blocks=1, filters=16, hw=8,
                    block=None):
    rng = np.random.default_rng(seed + scale)
    net = JaxGen(scale_factor=scale, growth_channels=growth,
                 num_rrdb_blocks=blocks, base_filters=filters,
                 attention_block_size=block)
    x = rng.random((2, hw, hw, 3), dtype=np.float32) * 2 - 1
    params = _random_biases(to_numpy(net.init(jax.random.PRNGKey(seed),
                                              jnp.asarray(x))["params"]), rng)
    return net, params, x


@pytest.mark.parametrize("scale", [2, 4])
def test_generator_matches_jax(scale):
    net, params, x = _generator_case(scale)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    model = esrgan_generator_from_flax(params, device="cpu")
    assert model.scale_factor == scale
    conv3x3.reset_launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8 * scale, 8 * scale, 3)
    np.testing.assert_allclose(got, want, atol=GEN_ATOL, rtol=0)
    assert conv3x3.LAUNCHES["conv3x3_bias_act"] == 0   # the twin on the CPU


def test_generator_blockwise_matches_jax():
    net, params, x = _generator_case(2, seed=3, block=16)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    model = esrgan_generator_from_flax(params, device="cpu",
                                       attention_block_size=16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=GEN_ATOL, rtol=0)


@pytest.mark.parametrize("scale", [3, 6, 0])
def test_generator_refuses_a_scale_that_is_not_a_power_of_2(scale):
    with pytest.raises(ValueError, match="power of 2"):
        ESRGANGenerator(scale_factor=scale, growth_channels=4,
                        num_rrdb_blocks=1, base_filters=8, device="cpu")


def test_discriminator_and_its_power_iteration_match_jax():
    rng = np.random.default_rng(5)
    x = rng.random((3, 24, 20, 3), dtype=np.float32)
    net = JaxDisc()
    v = net.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = _random_biases(to_numpy(v["params"]), rng)
    spectral = to_numpy(v["spectral"])
    model = esrgan_discriminator_from_flax(params, spectral, device="cpu")
    want = np.asarray(net.apply({"params": params, "spectral": spectral},
                                jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # update_stats=False leaves every u as it was
    for name, s in spectral.items():
        np.testing.assert_array_equal(getattr(model, name).u.numpy(), s["u"])
    # one power-iteration step of every u
    want, upd = net.apply({"params": params, "spectral": spectral},
                          jnp.asarray(x), update_stats=True,
                          mutable=["spectral"])
    with torch.no_grad():
        got = model(torch.from_numpy(x), update_stats=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    for name, s in upd["spectral"].items():
        np.testing.assert_allclose(getattr(model, name).u.numpy(),
                                   np.asarray(s["u"]), atol=1e-6, rtol=0)


def test_spectral_sigma_takes_no_gradient_through_u_and_v():
    rng = np.random.default_rng(6)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    net = JaxDisc()
    v = to_numpy(net.init(jax.random.PRNGKey(3), jnp.asarray(x)))

    def loss(params):
        return jnp.sum(net.apply({"params": params,
                                  "spectral": v["spectral"]}, jnp.asarray(x)))
    want = to_numpy(jax.grad(loss)(v["params"]))
    model = esrgan_discriminator_from_flax(v["params"], v["spectral"],
                                           device="cpu").requires_grad_(True)
    model(torch.from_numpy(x)).sum().backward()
    for name in ("conv1", "conv4", "dense1", "output"):
        layer = getattr(model, name)
        np.testing.assert_allclose(layer.kernel.grad.numpy(),
                                   want[name]["kernel"], atol=1e-6,
                                   rtol=1e-4)
        assert layer.u.grad is None


def test_parameter_counts_equal_jax():
    cfg = ESRGANConfig()
    gen = ESRGANGenerator(scale_factor=cfg.scale_factor,
                          growth_channels=cfg.growth_channels,
                          num_rrdb_blocks=cfg.num_rrdb_blocks, device="cpu")
    assert sum(p.numel() for p in gen.parameters()) == 1_162_915
    jax_gen = JaxGen(scale_factor=cfg.scale_factor,
                     growth_channels=cfg.growth_channels,
                     num_rrdb_blocks=cfg.num_rrdb_blocks)
    shapes = jax.eval_shape(jax_gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == 1_162_915
    disc = ESRGANDiscriminator(device="cpu")
    assert sum(p.numel() for p in disc.parameters()) == 658_305
    assert sum(b.numel() for b in disc.buffers()) == 961
    # the port's config is the JAX package's, value for value
    assert port_config.ESRGANConfig().__dict__ == cfg.__dict__


def test_super_resolve_full_image_matches_jax():
    net, params, _ = _generator_case(2, seed=7, filters=16)
    rng = np.random.default_rng(8)
    lr = rng.random((8, 8, 3), dtype=np.float32)
    want, want_m = jax_inf.super_resolve_full_image(
        net, {"params": params}, lr, attention_block_size=16)
    model = esrgan_generator_from_flax(params, device="cpu")
    got, metrics = inference.super_resolve_full_image(
        model, lr, attention_block_size=16)
    assert isinstance(got, np.ndarray) and got.shape == (16, 16, 3)
    np.testing.assert_allclose(got, want, atol=GEN_ATOL, rtol=0)
    assert set(metrics) == set(want_m)
    # the generator's own configuration is restored after the call
    assert model.attention_block_size is None


def test_super_resolve_image_normalize_pm1_matches_jax():
    net, params, _ = _generator_case(2, seed=9, filters=16)
    rng = np.random.default_rng(10)
    lr = rng.random((14, 12, 3), dtype=np.float32)
    want, _ = jax_inf.super_resolve_image(
        lambda p: net.apply({"params": params}, p), lr, patch_size_lr=8,
        stride=4, scale=2, normalize_pm1=True)
    model = esrgan_generator_from_flax(params, device="cpu")
    got, _ = inference.super_resolve_image(model, lr, patch_size_lr=8,
                                           stride=4, scale=2,
                                           normalize_pm1=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GEN_ATOL,
                               rtol=0)
