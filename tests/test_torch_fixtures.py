"""Shared inputs for the port's parity tests (tests/test_torch_*.py), plus a
check of the inputs themselves.

Everything is made with numpy from a seed and handed to both packages: the
flax trees go to the JAX functions as they are and to the port through
``tpusr_torch.bridge``.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tpusr.models import EDSR as JaxEDSR
from tpusr.models.vgg import _VGG16_CFG
from tpusr_torch.bridge import dense_to_linear, flax_path, oihw_to_hwio

NARROW_WIDTHS = (8, 16, 16, 32, 32)  # VGG16 layer names, narrow widths


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_flax_tree(params: dict) -> dict:
    """Port parameters (name -> tensor, as ``named_parameters`` or a
    trainer's ``TrainState.params`` hold them) -> a nested flax tree of
    numpy arrays in flax's layouts (HWIO conv kernels, (in, out) Dense)."""
    tree: dict = {}
    for name, t in params.items():
        a = t.detach().cpu()
        if name.endswith(".weight"):
            a = oihw_to_hwio(a) if a.dim() == 4 else dense_to_linear(a)
        *path, leaf = flax_path(name)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a.numpy().copy()
    return tree


def vgg16_tree(rng, widths=NARROW_WIDTHS, num_classes=2, dense_units=16):
    """A VGG16Classifier-shaped flax tree (He-scaled kernels, small random
    biases) at the given block widths."""
    bb, cin = {}, 3
    for (block, n_convs, _f), wd in zip(_VGG16_CFG, widths):
        for ci in range(1, n_convs + 1):
            k = rng.standard_normal((3, 3, cin, wd)) * np.sqrt(2.0 / (9 * cin))
            bb[f"block{block}_conv{ci}"] = {
                "kernel": k.astype(np.float32),
                "bias": (rng.standard_normal(wd) * 0.05).astype(np.float32)}
            cin = wd

    def dense(n_in, n_out):
        return {"kernel": (rng.standard_normal((n_in, n_out))
                           * np.sqrt(1.0 / n_in)).astype(np.float32),
                "bias": (rng.standard_normal(n_out) * 0.05).astype(np.float32)}

    return {"vgg16": bb, "fc1": dense(cin, dense_units),
            "predictions": dense(dense_units, num_classes)}


def edsr_tree(rng, scale, num_res_blocks=2, num_filters=8):
    """flax-initialised EDSR params with random (non-zero) biases."""
    m = JaxEDSR(scale_factor=scale, num_res_blocks=num_res_blocks,
                num_filters=num_filters)
    params = to_numpy(m.init(jax.random.PRNGKey(scale),
                             jnp.zeros((1, 8, 8, 3)))["params"])

    def with_bias(p):
        if isinstance(p, dict) and "bias" in p:
            b = (rng.standard_normal(p["bias"].shape) * 0.02).astype(np.float32)
            return {**p, "bias": b}
        return {k: with_bias(v) for k, v in p.items()}

    return m, with_bias(params)


def center_classifier_bias(params, probs):
    """``params`` with the class-1 bias shifted by minus the median per-image
    median patch log-odds of ``probs`` (N, P, 2), so votes split between the
    classes (the numpy form of __graft_entry__._center_classifier_bias)."""
    probs = np.asarray(probs, np.float64)
    logodds = np.log(np.clip(probs[..., 1], 1e-9, None)
                     / np.clip(probs[..., 0], 1e-9, None))
    delta = -float(np.median(np.median(logodds, axis=1)))
    pred = dict(params["predictions"])
    bias = pred["bias"].copy()
    bias[1] += delta
    pred["bias"] = bias.astype(np.float32)
    return {**params, "predictions": pred}


def test_vgg16_tree_has_vgg16_layer_names_and_widths():
    tree = vgg16_tree(np.random.default_rng(0))
    names = [f"block{b}_conv{c}" for b, n, _f in _VGG16_CFG
             for c in range(1, n + 1)]
    assert list(tree["vgg16"]) == names
    outs = [tree["vgg16"][f"block{b}_conv1"]["kernel"].shape[-1]
            for b, _n, _f in _VGG16_CFG]
    assert tuple(outs) == NARROW_WIDTHS
    assert tree["fc1"]["kernel"].shape == (NARROW_WIDTHS[-1], 16)
