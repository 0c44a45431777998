"""The port's cv2-parity resize (tpusr_torch/core/resize.py) against the JAX
package's (tpusr/core/resize.py): the same weight matrices, and the two
matrix products to 1e-3 on [0, 255] images."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusr.core.resize import resize as jax_resize
from tpusr.core.resize import resize_weights as jax_resize_weights
from tpusr_torch.core.resize import METHODS, resize, resize_weights

IN_HW = (12, 10)
OUT_HW = {"x4 up": (48, 40), "div4 down": (3, 2), "non-integer": (17, 23)}


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("ratio", sorted(OUT_HW))
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method, ratio, channels):
    out_hw = OUT_HW[ratio]
    in_hw = IN_HW if ratio != "div4 down" else (12, 8)
    shape = in_hw if channels is None else in_hw + (channels,)
    x = np.random.default_rng(len(method) + len(ratio)).random(shape) * 255.0
    x = x.astype(np.float32)
    for n_in, n_out in zip(in_hw, out_hw):
        np.testing.assert_array_equal(resize_weights(n_in, n_out, method),
                                      jax_resize_weights(n_in, n_out, method))
    got = resize(torch.from_numpy(x), out_hw, method)
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw, method))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
