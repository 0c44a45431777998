"""The port's VGG19 perceptual extractor and caffe preprocessing
(tpusr_torch/models/vgg.py) against the JAX package's (tpusr/models/vgg.py)
on the CPU: the same weights (drawn by the port, handed to JAX as a flax
tree), the same numpy images. Tolerance: 1e-5 relative to the largest
output (float32 convs summed in another order than XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr_torch.bridge import to_flax_tree
from tpusr.models.vgg import VGG19Features as JaxVGG19
from tpusr.models.vgg import _VGG19_CFG, _VGGBackbone
from tpusr.models.vgg import preprocess_caffe as jax_preprocess_caffe
from tpusr_torch.bridge import vgg19_features_from_flax
from tpusr_torch.models.vgg import (IMAGENET_BGR_MEAN, VGG19_CFG,
                                    VGG16Classifier, VGG19Features,
                                    _VGGBackbone as PortBackbone,
                                    preprocess_caffe)

RTOL = 1e-5


def test_preprocess_caffe_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((2, 5, 7, 3), dtype=np.float32) * 255
    got = preprocess_caffe(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_preprocess_caffe(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    # BGR: channel 0 of the output is the blue input minus the blue mean
    np.testing.assert_array_equal(got[..., 0],
                                  x[..., 2] - np.float32(IMAGENET_BGR_MEAN[0]))
    assert VGG19_CFG == _VGG19_CFG


@pytest.fixture(scope="module")
def vgg19():
    model = VGG19Features(device="cpu",
                          generator=torch.Generator().manual_seed(4))
    with torch.no_grad():                      # non-zero biases
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(5))
    return model, to_flax_tree(dict(model.named_parameters()))


@pytest.mark.parametrize("hw", [(16, 16), (32, 48)])
def test_vgg19_features_match_jax(vgg19, hw):
    model, tree = vgg19
    rng = np.random.default_rng(hw[1])
    x = rng.random((2, *hw, 3), dtype=np.float32) * 255
    xin = preprocess_caffe(torch.from_numpy(x))
    with torch.no_grad():
        got = model(xin).numpy()
    want = np.asarray(JaxVGG19().apply(
        {"params": tree}, jax_preprocess_caffe(jnp.asarray(x))))
    assert got.shape == want.shape == (2, hw[0] // 16, hw[1] // 16, 512)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_bridge_and_parameter_count(vgg19):
    model, tree = vgg19
    back = vgg19_features_from_flax(tree, device="cpu")
    sa, sb = back.state_dict(), model.state_dict()
    assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    # block5_conv4 is the last layer: the whole VGG19 conv base
    assert sum(p.numel() for p in model.parameters()) == 20_024_384
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("until", ["block1_conv1", "block3_conv2"])
def test_backbone_stops_after_the_named_layer_as_jax(until):
    cfg = tuple((b, n, 4) for b, n, _f in VGG19_CFG)
    port = PortBackbone(cfg, torch.Generator().manual_seed(6), until=until)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 12, 12, 3)).astype(np.float32)
    net = _VGGBackbone(cfg, until=until)
    params = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x))["params"])
    # the port holds exactly the layers up to `until`, as flax creates them
    assert [f"{k}" for k in port] == list(params)
    tree = to_flax_tree({f"{k}.{leaf}": getattr(m, leaf)
                         for k, m in port.items() for leaf in ("weight", "bias")})
    want = np.asarray(net.apply({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_an_unknown_stop_layer_raises():
    with pytest.raises(ValueError, match="matched no layer"):
        PortBackbone(VGG19_CFG, torch.Generator(), until="block6_conv1")
    net = _VGGBackbone(_VGG19_CFG, until="block6_conv1")
    with pytest.raises(ValueError, match="matched no layer"):
        net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))


def test_vgg16_classifier_keeps_its_parameter_names_and_draws():
    """VGG16 now builds its conv base with the shared backbone; its names
    (``vgg16.block{b}_conv{c}.weight``) and its draws from the generator
    are the flax tree's and the earlier port's order: conv layers, then the
    two Dense layers."""
    m = VGG16Classifier(widths=(4, 4, 8, 8, 8), dense_units=4, device="cpu",
                        generator=torch.Generator().manual_seed(8))
    names = [k for k, _ in m.named_parameters()]
    assert names[:2] == ["vgg16.block1_conv1.weight", "vgg16.block1_conv1.bias"]
    assert names[-4:] == ["fc1.weight", "fc1.bias", "predictions.weight",
                          "predictions.bias"]
    assert len(names) == 2 * 13 + 4
    g = torch.Generator().manual_seed(8)
    from tpusr_torch.models.init import variance_scaling
    first = variance_scaling((3, 3, 3, 4), 27, 1.0, g)
    assert torch.equal(m.vgg16["block1_conv1"].weight,
                       first.permute(3, 2, 0, 1))


def test_bf16_forward_runs_in_bf16(vgg19):
    model, _ = vgg19
    x = preprocess_caffe(torch.rand(1, 16, 16, 3) * 255)
    params = {k: v.bfloat16() for k, v in model.named_parameters()}
    with torch.no_grad():
        out = torch.func.functional_call(model, params, (x.bfloat16(),))
        ref = model(x)
    assert out.dtype == torch.bfloat16
    # 16 bf16 convs, each rounding at 2^-8: within 16 * 2^-8 of the f32 scale
    assert float((out.float() - ref).abs().max()) <= 16 * 2.0 ** -8 * float(
        ref.abs().max())
