"""Shared inputs for the port's parity tests (tests/test_torch_*.py), plus a
check of the inputs themselves.

Everything is made with numpy from a seed and handed to both packages: the
flax trees go to the JAX functions as they are and to the port through
``tpusr_torch.bridge``.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp

from tpusr.models import EDSR as JaxEDSR
from tpusr.models.vgg import _VGG16_CFG

NARROW_WIDTHS = (8, 16, 16, 32, 32)  # VGG16 layer names, narrow widths


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


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


# ----------------------------------------------------------- Keras fixtures
# The networks of the committed Keras .h5 fixtures (tests/data/keras/):
# name -> (JAX module, init input shape, flax collections, numpy seed).
# ``keras_fixture_tree`` draws their weights with numpy at the shapes of the
# module's init, so the fixture script and the tests make the same trees.
def _keras_nets():
    from tpusr.models import (EDSR, SRCNN, ESRGANDiscriminator,
                              ESRGANGenerator, VGG16Classifier)
    return {
        "srcnn": (SRCNN(f1=16, f2=8), (1, 24, 24, 3), ("params",), 11),
        "edsr_x2": (EDSR(scale_factor=2, num_res_blocks=2, num_filters=8),
                    (1, 8, 8, 3), ("params",), 12),
        "edsr_x4": (EDSR(scale_factor=4, num_res_blocks=2, num_filters=8),
                    (1, 8, 8, 3), ("params",), 13),
        "esrgan_generator": (ESRGANGenerator(scale_factor=4, growth_channels=4,
                                             num_rrdb_blocks=1,
                                             base_filters=16),
                             (1, 8, 8, 3), ("params",), 14),
        "esrgan_discriminator": (ESRGANDiscriminator(), (1, 24, 24, 3),
                                 ("params", "spectral"), 15),
        "vgg16_classifier": (VGG16Classifier(num_classes=2), (1, 96, 96, 3),
                             ("params",), 16),
    }


KERAS_FULL = ("srcnn", "edsr_x2", "edsr_x4", "esrgan_generator")
KERAS_SKELETONS = ("esrgan_discriminator", "vgg16_classifier")


def seeded_tree(module, sample, collections=("params",), seed=0):
    """``module``'s flax trees (one per collection) at the shapes of its
    init on ``sample``'s shape, drawn from ``seed``: standard normal x 0.1,
    float32, leaves in sorted key order."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros(sample)))
    rng = np.random.default_rng(seed)

    def fill(node):
        if hasattr(node, "keys"):
            return {k: fill(node[k]) for k in sorted(node.keys())}
        return (rng.standard_normal(node.shape) * 0.1).astype(np.float32)

    return tuple(fill(shapes[c]) for c in collections)


def keras_fixture_tree(name: str):
    """The Keras fixture ``name``'s flax trees, drawn from its seed."""
    module, sample, collections, seed = _keras_nets()[name]
    return seeded_tree(module, sample, collections, seed)


def _h5py_attr(obj, name):
    """[name, type, shape, value] of one attribute, as h5py reads it; the
    same form as ``tpusr_torch.train.hdf5.describe``."""
    import h5py

    aid = h5py.h5a.open(obj.id, name.encode())
    t, space = aid.get_type(), aid.get_space()
    cset = {0: "ascii", 1: "utf8"}
    if t.get_class() == h5py.h5t.STRING:
        if t.is_variable_str():
            kind = f"vlen-str/{cset[t.get_cset()]}"
        else:
            pad = {0: "nullterm", 1: "nullpad", 2: "spacepad"}[t.get_strpad()]
            kind = f"str{t.get_size()}/{pad}/{cset[t.get_cset()]}"
    else:
        kind = t.dtype.str
    stype = space.get_simple_extent_type()
    shape = ("null" if stype == h5py.h5s.NULL else
             None if stype == h5py.h5s.SCALAR else list(space.shape))
    return [name, kind, shape, _jsonable(name, obj.attrs[name])]


def _jsonable(name, v):
    import json

    if isinstance(v, (bytes, np.bytes_)):
        v = v.decode("utf-8")
    if isinstance(v, str):
        return json.loads(v) if name in ("model_config",
                                         "training_config") else v
    if isinstance(v, np.ndarray):
        return [_jsonable(name, x) for x in v.tolist()] if v.ndim else \
            _jsonable(name, v[()])
    if isinstance(v, (np.generic,)):
        return v.item()
    if isinstance(v, list):
        return [_jsonable(name, x) for x in v]
    return None if type(v).__name__ == "Empty" else v


def h5_describe(path: str) -> list:
    """h5py's view of an HDF5 file as JSON-able records, in h5py's order
    (each group's attributes, then its members by ``keys()``): groups with
    their attributes, datasets with shape, dtype and the sha256 of their
    bytes."""
    import hashlib

    import h5py

    out = []

    def walk(path_, obj):
        attrs = [_h5py_attr(obj, k) for k in obj.attrs.keys()]
        if isinstance(obj, h5py.Dataset):
            v = obj[()]
            if isinstance(v, h5py.Empty):
                shape, dtype, sha = "null", v.dtype.str, None
            else:
                a = np.asarray(v)
                if a.dtype == object:
                    a = np.array([bytes(x) for x in a.reshape(-1)]).reshape(
                        a.shape)
                shape, dtype = list(a.shape), a.dtype.str
                sha = hashlib.sha256(
                    np.ascontiguousarray(a).tobytes()).hexdigest()
            out.append({"path": path_, "kind": "dataset", "shape": shape,
                        "dtype": dtype, "sha256": sha, "attrs": attrs})
            return
        out.append({"path": path_, "kind": "group", "attrs": attrs})
        for k in obj.keys():
            walk(f"{path_.rstrip('/')}/{k}", obj[k])

    with h5py.File(path, "r") as f:
        walk("/", f)
    return out


def h5_from_records(records: list, arrays: list, path: str) -> None:
    """Write with h5py the file that ``records`` (``h5_describe``'s form)
    describe: groups and attributes with their recorded types, each
    dataset's bytes found among ``arrays`` by its sha256. A committed
    skeleton plus its seeded weights gives back the exporter's file."""
    import hashlib

    import h5py

    by_sha = {hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes())
              .hexdigest(): np.asarray(a, np.float32) for a in arrays}
    with h5py.File(path, "w") as f:
        for rec in records:
            if rec["kind"] == "dataset":
                obj = f.create_dataset(
                    rec["path"], data=by_sha[rec["sha256"]].reshape(
                        rec["shape"]).astype(rec["dtype"]))
            else:
                obj = f.require_group(rec["path"])
            for name, kind, shape, value in rec["attrs"]:
                if name == "model_config":
                    value = json.dumps(value)
                if kind.startswith("vlen-str"):
                    enc = (lambda v: v.encode("utf-8")) if kind.endswith(
                        "ascii") else (lambda v: v)
                    obj.attrs[name] = ([enc(v) for v in value]
                                       if shape is not None else enc(value))
                else:
                    obj.attrs[name] = np.asarray(value, kind).reshape(shape)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    return [tree]


def vgg_layers(arch: str, seed: int = 0, widths=None) -> dict:
    """{layer: {'kernel': HWIO, 'bias'}} of a seeded VGG16/VGG19 backbone
    (He-scaled kernels), at ``widths`` per block when given."""
    from tpusr_torch.tools.imagenet_weights import _CFGS

    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for b, n, f in _CFGS[arch]:
        f = widths[b - 1] if widths else f
        for c in range(1, n + 1):
            out[f"block{b}_conv{c}"] = {
                "kernel": (rng.standard_normal((3, 3, cin, f))
                           * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                "bias": (rng.standard_normal(f) * 0.1).astype(np.float32)}
            cin = f
    return out


def write_notop_h5(path, layers: dict, keras1_names: bool = False) -> str:
    """A Keras ``save_weights`` file of a VGG base as the official
    ``*_notop.h5`` releases lay it out (layer groups at the root, the
    input and pool layers weightless, fixed-length name lists): weight
    names ``block1_conv1/kernel:0``, or with ``keras1_names`` the Keras 1
    form ``block1_conv1_W_1:0`` with no '/'."""
    import h5py

    names = ["input_1"]
    for layer in layers:
        if names[-1].startswith("block") and names[-1][:6] != layer[:6]:
            names.append(f"{names[-1][:6]}_pool")
        names.append(layer)
    names.append(f"{names[-1][:6]}_pool")
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names])
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["keras_version"] = np.bytes_(b"2.2.4")
        for name in names:
            g = f.create_group(name)
            if name not in layers:
                g.attrs["weight_names"] = np.array([])
                continue
            if keras1_names:
                wn = [f"{name}_W_1:0", f"{name}_b_1:0"]
            else:
                wn = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = np.array([w.encode() for w in wn])
            g.create_dataset(wn[0], data=layers[name]["kernel"])
            g.create_dataset(wn[1], data=layers[name]["bias"])
    return str(path)
