"""K1 and K2 of the port (tpusr_torch/core/conv3x3.py) against the JAX package.

On the CPU the wrappers run their plain twins; these tests hold the twins
against XLA's conv + requant (quant.py:108-115) and the Pallas kernels in
interpret mode (tpusr/core/pallas_conv.py). The CUDA kernels themselves are
held against the twins on the card by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusr.core.pallas_conv import conv3x3_bias_act as pallas_bias_act
from tpusr.core.pallas_conv import conv3x3_int8_requant as pallas_requant
from tpusr_torch.core import conv3x3 as k

_DN = ("NHWC", "HWIO", "NHWC")

# (N, H, W, Cin, Cout): tests/test_edsr_fast.py:86-89's shape, the first VGG
# layer (Cin = 3), the EDSR tail (Cout = 3), and odd sizes
K1_SHAPES = [(2, 12, 12, 128, 128), (2, 9, 7, 3, 64), (3, 5, 6, 16, 8),
             (1, 4, 4, 64, 3)]
K2_SHAPES = [(2, 12, 12, 64, 64), (2, 9, 7, 3, 64), (1, 6, 5, 64, 3),
             (2, 5, 4, 16, 256)]


def _int8_inputs(shape, seed):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    # rescale spreads outputs over [0, 127]: |acc| ~ sqrt(9*cin) * 127^2 / 3
    rs = (rng.random(cout) * 200.0 / (np.sqrt(9 * cin) * 5400.0)).astype(np.float32)
    b = (rng.random(cout) * 20.0 - 10.0 + 0.5).astype(np.float32)
    return x, wq, rs, b


def _xla_requant(x, wq, rs, b):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), (1, 1), "SAME", dimension_numbers=_DN,
        preferred_element_type=jnp.int32)
    return np.asarray(jnp.clip(y.astype(jnp.float32) * rs + b, 0.0, 127.0)
                      .astype(jnp.int8))


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_plain_twin_bit_exact_with_xla_and_pallas(shape):
    x, wq, rs, b = _int8_inputs(shape, seed=sum(shape))
    k.reset_launch_counts()
    got = k.conv3x3_int8_requant(torch.from_numpy(x), torch.from_numpy(wq),
                                 torch.from_numpy(rs), torch.from_numpy(b))
    assert got.dtype == torch.int8 and tuple(got.shape) == shape[:3] + shape[4:]
    want = _xla_requant(x, wq, rs, b)
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(pallas_requant(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.asarray(rs), jnp.asarray(b),
                                       interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    # outputs cover the clip range, so the test sees both clips and interior
    assert got.min() == 0 and got.max() == 127 and len(np.unique(want)) > min(50, want.size // 4)
    # a CPU tensor never reaches the kernel
    assert k.LAUNCHES["conv3x3_int8_requant"] == 0


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plain_twin_matches_xla_and_pallas(shape, relu):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape) + relu)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    kern = (rng.standard_normal((3, 3, cin, cout))
            / np.sqrt(9 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    k.reset_launch_counts()
    got = k.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(kern),
                             torch.from_numpy(b), relu=relu).numpy()
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (1, 1), "SAME",
        dimension_numbers=_DN, precision=jax.lax.Precision.HIGHEST) + b
    if relu:
        want = jnp.maximum(want, 0.0)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    pallas = pallas_bias_act(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(b),
                             relu=relu, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=0)
    assert k.LAUNCHES["conv3x3_bias_act"] == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    x8 = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w8 = torch.zeros((3, 3, 8, 4), dtype=torch.int8)
    v = torch.zeros(4)
    with pytest.raises(TypeError):
        k.conv3x3_int8_requant(x8.float(), w8, v, v)
    with pytest.raises(ValueError):
        k.conv3x3_int8_requant(x8, w8[:, :, :4], v, v)
    with pytest.raises(ValueError):
        k.conv3x3_int8_requant(x8, w8, v[:3], v)
    with pytest.raises(TypeError):
        k.conv3x3_bias_act(x8.float().double(), w8.float(), v)
    with pytest.raises(ValueError):
        k.conv3x3_bias_act(x8.float()[0], w8.float(), v)
    with pytest.raises(ValueError):  # no device other than cpu/cuda
        k.conv3x3_bias_act(x8.float().to("meta"), w8.float().to("meta"),
                           v.to("meta"))
