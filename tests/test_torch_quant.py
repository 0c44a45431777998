"""The port's int8 VGG16 path (tpusr_torch/models/quant.py) against
tpusr/models/quant.py, on a narrow VGG16-shaped tree (real widths cost
95-200 s per int8 conv stack on XLA:CPU), plus the full-width f32
classifier."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import to_numpy, vgg16_tree
from tpusr.models import VGG16Classifier as JaxVGG16
from tpusr.models import quant as jq
from tpusr.models.vgg import _VGG16_CFG
from tpusr_torch.bridge import qtree_from_flax, vgg16_from_flax
from tpusr_torch.core import conv3x3
from tpusr_torch.models import quant as tq

_DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(0)
    params = vgg16_tree(rng)
    calib = rng.random((6, 32, 32, 3), dtype=np.float32)
    scales = jq.calibrate_vgg16(params, calib)
    qtree = to_numpy(jq.quantize_vgg16(params, scales))
    patches = rng.random((5, 32, 32, 3), dtype=np.float32)
    return params, calib, scales, qtree, patches


def test_int8_activations_bit_exact_per_layer(narrow):
    params, _, _, qtree, patches = narrow
    q = qtree_from_flax(qtree, device="cpu")
    xj = jq.quantize_input(qtree, jnp.asarray(patches))
    xt = tq.quantize_input(q, torch.from_numpy(patches))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    conv3x3.reset_launch_counts()
    for block, n_convs, _f in _VGG16_CFG:
        for ci in range(1, n_convs + 1):
            name = f"block{block}_conv{ci}"
            lj, lt = qtree["layers"][name], q["layers"][name]
            y = jax.lax.conv_general_dilated(
                xj, jnp.asarray(lj["kernel_q"]), (1, 1), "SAME",
                dimension_numbers=_DN, preferred_element_type=jnp.int32)
            xj = jnp.clip(y.astype(jnp.float32) * lj["rescale"]
                          + lj["bias_over_out"], 0.0, 127.0).astype(jnp.int8)
            xt = conv3x3.conv3x3_int8_requant(xt, lt["kernel_q"], lt["rescale"],
                                              lt["bias_over_out"])
            np.testing.assert_array_equal(xt.numpy(), np.asarray(xj),
                                          err_msg=name)
            assert len(np.unique(np.asarray(xj))) > 8, name  # not collapsed
        xj = jax.lax.reduce_window(xj, jnp.int8(-128), jax.lax.max,
                                   (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        xt = tq.max_pool2x2(xt)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    # the backbone and the whole forward through the modules' own functions
    xq = jq.quantize_input(qtree, jnp.asarray(patches))
    np.testing.assert_array_equal(
        tq.int8_backbone(q, torch.from_numpy(np.array(xq))).numpy(),
        np.asarray(jq.int8_backbone(qtree, xq)))
    want = np.asarray(jq.quantized_vgg16_apply(qtree, jnp.asarray(patches)))
    got = tq.quantized_vgg16_apply(q, torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert conv3x3.LAUNCHES["conv3x3_int8_requant"] == 0


def test_port_calibration_matches_jax(narrow):
    params, calib, scales, _, _ = narrow
    model = vgg16_from_flax(params, device="cpu")
    got = tq.calibrate_vgg16(model, calib)
    assert set(got) == set(scales)
    for name, s in scales.items():
        np.testing.assert_allclose(got[name], s, rtol=1e-5, err_msg=name)


def test_port_quantization_is_exact(narrow):
    params, _, scales, qtree, patches = narrow
    q = tq.quantize_vgg16(vgg16_from_flax(params, device="cpu"), scales)
    for name, lj in qtree["layers"].items():
        lt = q["layers"][name]
        assert lt["kernel_q"].dtype == torch.int8
        np.testing.assert_array_equal(lt["kernel_q"].numpy(), lj["kernel_q"])
        np.testing.assert_array_equal(lt["rescale"].numpy(), lj["rescale"])
        np.testing.assert_array_equal(lt["bias_over_out"].numpy(),
                                      lj["bias_over_out"])
    assert q["final_scale"] == qtree["final_scale"]
    np.testing.assert_array_equal(q["head"]["fc1"]["kernel"].numpy(),
                                  qtree["head"]["fc1"]["kernel"])
    # quantize_input: exact, including values on .5 boundaries of the grid
    s = scales["__input__"]
    imgs = np.concatenate([patches.ravel()[:1000],
                           (np.arange(-20, 20) + 0.5).astype(np.float32)
                           * np.float32(s)]).reshape(1, -1, 1, 1)
    np.testing.assert_array_equal(
        tq.quantize_input(q, torch.from_numpy(imgs)).numpy(),
        np.asarray(jq.quantize_input(qtree, jnp.asarray(imgs))))


def test_full_width_f32_classifier_matches_flax():
    m = JaxVGG16(num_classes=2)
    params = to_numpy(m.init(jax.random.PRNGKey(3),
                             jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.default_rng(3)
    for name in params["vgg16"]:
        b = params["vgg16"][name]["bias"]
        params["vgg16"][name]["bias"] = (rng.standard_normal(b.shape)
                                         * 0.05).astype(np.float32)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    model = vgg16_from_flax(params, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
