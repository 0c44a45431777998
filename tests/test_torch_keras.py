"""The port's Keras ``.h5`` importers and exporters
(``tpusr_torch/train/keras_import.py``, ``keras_export.py``) against the
JAX package's (``tpusr/train/keras_import.py``, ``keras_export.py``).

Import: the committed fixtures that JAX's exporters wrote with Keras 3
(``tests/data/keras/``; the discriminator and VGG16 rebuilt from their
skeletons and seeded weights), and Keras 2 layouts written here with h5py
(``model_weights``, fixed-length names, ``:0`` suffixes, a split
``layer_names0``/``layer_names1``). The port's imported tensors equal JAX's
arrays bit for bit after the bridge, and the port's forward matches JAX's
within the tolerances of the existing parity tests (SR networks 1e-5, the
discriminator 1e-6, VGG16 1e-5 of the largest output).

Export: h5py's view of the port's file equals the fixture from JAX's
exporter for the same weights, taken through the port's modules and the
inverse bridge: the tree in order, attribute names, types and values
(``model_config`` as parsed JSON), dataset shapes, dtypes and bytes. JAX's
``keras_import`` on the port's file gives back the port's weights.
"""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import (KERAS_FULL, _keras_nets, h5_describe,
                                 h5_from_records, keras_fixture_tree,
                                 tree_leaves, vgg16_tree)
from tpusr.train import keras_import as jki
from tpusr_torch import bridge
from tpusr_torch.models.srcnn import SRCNN
from tpusr_torch.train import keras_export, keras_import

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "keras")
NETS = ["srcnn", "edsr_x2", "edsr_x4", "esrgan_generator",
        "esrgan_discriminator", "vgg16_classifier"]
TOL = {"srcnn": 1e-5, "edsr_x2": 1e-5, "edsr_x4": 1e-5,
       "esrgan_generator": 1e-5, "esrgan_discriminator": 1e-6,
       "vgg16_classifier": 1e-5}


def fixture_records(name):
    if name in KERAS_FULL:
        with open(os.path.join(HERE, "manifest.json")) as f:
            return json.load(f)["files"][f"{name}.h5"]
    with open(os.path.join(HERE, f"{name}.skeleton.json")) as f:
        return json.load(f)


def fixture_path(name, tmp_path):
    """JAX's exporter's file for ``name``: committed, or rebuilt from the
    skeleton with the seeded weights (its sha256s are checked on the way)."""
    if name in KERAS_FULL:
        return os.path.join(HERE, f"{name}.h5")
    path = str(tmp_path / f"{name}.h5")
    leaves = [a for t in keras_fixture_tree(name) for a in tree_leaves(t)]
    h5_from_records(fixture_records(name), leaves, path)
    assert h5_describe(path) == fixture_records(name)
    return path


def port_module(name, trees):
    """The port's module holding the seeded weights."""
    if name == "srcnn":
        return bridge.srcnn_from_flax(trees[0], "cpu")
    if name.startswith("edsr"):
        return bridge.edsr_from_flax(trees[0], int(name[-1]), device="cpu")
    if name == "esrgan_generator":
        return bridge.esrgan_generator_from_flax(trees[0], "cpu")
    if name == "esrgan_discriminator":
        return bridge.esrgan_discriminator_from_flax(trees[0], trees[1], "cpu")
    return bridge.vgg16_from_flax(trees[0], "cpu")


def port_trees(name, module):
    """The module's weights as flax trees (the inverse bridge)."""
    params = dict(module.named_parameters())
    if name == "esrgan_generator":
        return (bridge.esrgan_generator_to_flax(params),)
    if name == "esrgan_discriminator":
        return (bridge.to_flax_tree(params),
                bridge.to_flax_tree(dict(module.named_buffers())))
    return (bridge.to_flax_tree(params),)


def zeros(tree):
    return jax.tree.map(np.zeros_like, tree)


def import_both(name, path, shapes=None):
    """(JAX's imported trees, the port's imported module) of ``path``,
    each from a zero template of ``shapes`` (the fixture's trees)."""
    trees = tuple(zeros(t) for t in shapes or keras_fixture_tree(name))
    template = port_module(name, trees)
    params = dict(template.named_parameters())
    if name == "srcnn":
        want = (jki.import_srcnn(trees[0], path),)
        got = keras_import.import_srcnn(params, path, device="cpu")
    elif name.startswith("edsr"):
        s = int(name[-1])
        want = (jki.import_edsr(trees[0], path, num_res_blocks=2,
                                scale_factor=s),)
        got = keras_import.import_edsr(params, path, num_res_blocks=2,
                                       scale_factor=s, device="cpu")
    elif name == "esrgan_generator":
        want = (jki.import_esrgan_generator(trees[0], path),)
        got = keras_import.import_esrgan_generator(params, path, device="cpu")
    elif name == "esrgan_discriminator":
        want = jki.import_esrgan_discriminator(trees[0], trees[1], path)
        got = keras_import.import_esrgan_discriminator(
            params, dict(template.named_buffers()), path, device="cpu")
    else:
        want = (jki.import_vgg16_classifier(trees[0], path),)
        got = keras_import.import_vgg16_classifier(params, path, device="cpu")
    return jax.tree.map(np.asarray, want), got


def assert_trees_equal(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for p, v in flat_g:
        w = flat_w[p]
        assert v.shape == w.shape and v.dtype == w.dtype, p
        assert np.array_equal(v, w), p


def forward_both(name, trees, module):
    module_j = _keras_nets()[name][0]
    rng = np.random.default_rng(9)
    hw = {"esrgan_discriminator": 24, "vgg16_classifier": 32}.get(name, 8)
    x = rng.random((2, hw, hw, 3), dtype=np.float32)
    variables = {"params": trees[0]}
    if name == "esrgan_discriminator":
        variables["spectral"] = trees[1]
    want = np.asarray(module_j.apply(variables, jnp.asarray(x)))
    module.eval()
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("name", NETS)
def test_import_of_jax_exporters_file_equals_jax(name, tmp_path):
    path = fixture_path(name, tmp_path)
    want, module = import_both(name, path)
    got = port_trees(name, module)
    assert_trees_equal(got, want)
    assert_trees_equal(got, keras_fixture_tree(name))
    out, ref = forward_both(name, want, module)
    tol = TOL[name] * (np.abs(ref).max() if name == "vgg16_classifier" else 1)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("name", NETS)
def test_export_equals_jax_exporters_file(name, tmp_path):
    """Seeded weights -> the port's module -> the inverse bridge -> the
    port's exporter: h5py's view equals JAX's exporter's file record for
    record; JAX's importer reads the port's weights back."""
    module = port_module(name, keras_fixture_tree(name))
    trees = port_trees(name, module)
    path = str(tmp_path / f"{name}.h5")
    if name == "srcnn":
        keras_export.export_srcnn(trees[0], path)
    elif name.startswith("edsr"):
        keras_export.export_edsr(trees[0], path)
    elif name == "esrgan_generator":
        keras_export.export_esrgan_generator(trees[0], path)
    elif name == "esrgan_discriminator":
        keras_export.export_esrgan_discriminator(trees[0], trees[1], path,
                                                 input_hw=24)
    else:
        keras_export.export_vgg16_classifier(trees[0], path)
    assert h5_describe(path) == fixture_records(name)
    want, _module = import_both(name, path)
    assert_trees_equal(trees, want)


# ------------------------------------------------------------ Keras 2 files
def keras2_layers(name, trees):
    """[(layer, [(weight name, array)])] as tf.keras 2 named them: auto
    names for SRCNN/EDSR (``conv2d_N``), ``:0`` suffixes, the SN wrapper's
    ``sn_u`` (tensorflow_addons), a weightless layer among them."""
    p = trees[0]
    if name == "srcnn" or name.startswith("edsr"):
        if name == "srcnn":
            order = [p["conv1"], p["conv2"], p["conv3"]]
        else:
            n_up = 2 if name.endswith("4") else 1
            order = ([p["head"]] + [p[f"res{i}"][c] for i in range(2)
                                   for c in ("conv1", "conv2")]
                     + [p["body"]] + [p[f"up{i}"] for i in range(n_up)]
                     + [p["tail"]])
        out = [("input_1", [])]
        for i, node in enumerate(order):
            lname = "conv2d" if i == 0 else f"conv2d_{i}"
            out.append((lname, [(f"{lname}/kernel:0", node["kernel"]),
                                (f"{lname}/bias:0", node["bias"])]))
            if i == 1:
                out.append(("lambda", []))
        return out
    if name == "esrgan_generator":
        out = []

        def conv(lname, node):
            out.append((lname, [(f"{lname}/kernel:0", node["kernel"]),
                                (f"{lname}/bias:0", node["bias"])]))
        conv("initial_conv", p["initial_conv"])
        for j in (1, 2, 3):
            for k in range(1, 6):
                conv(f"rrdb_0_dense{j}_conv{k}", p["rrdb_0"][f"dense{j}"][f"conv{k}"])
        conv("trunk_conv", p["trunk_conv"])
        for att in ("self_attention_trunk", "self_attention_upsample_0"):
            out.append((att, [(f"{att}/{att}_{t}/{leaf}:0", p[att][t][leaf])
                              for t in "fghv" for leaf in ("kernel", "bias")]))
        for i in (0, 1):
            conv(f"upsample_{i}_conv", p[f"upsample_{i}_conv"])
        conv("final_conv1", p["final_conv1"])
        conv("final_conv2", p["final_conv2"])
        return out
    if name == "esrgan_discriminator":
        inner = {f"conv{i}": f"disc_conv{i}" for i in range(1, 7)}
        inner.update(dense1="disc_dense1", output="disc_output")
        out = []
        for i, (flax, keras) in enumerate(inner.items()):
            sn = "spectral_normalization" + (f"_{i}" if i else "")
            out.append((sn, [(f"{sn}/{keras}/kernel:0", p[flax]["kernel"]),
                             (f"{sn}/{keras}/bias:0", p[flax]["bias"]),
                             (f"{sn}/sn_u:0",
                              np.reshape(trees[1][flax]["u"], (1, -1)))]))
        return out
    vgg = [(f"{n}/{leaf}:0", p["vgg16"][n][leaf]) for n in p["vgg16"]
           for leaf in ("kernel", "bias")]
    return [("input_2", []), ("vgg16", vgg),
            ("dense", [("dense/kernel:0", p["fc1"]["kernel"]),
                       ("dense/bias:0", p["fc1"]["bias"])]),
            ("predictions", [("predictions/kernel:0",
                              p["predictions"]["kernel"]),
                             ("predictions/bias:0",
                              p["predictions"]["bias"])])]


def write_keras2(path, layers, split=False):
    """A tf.keras 2 ``model.save`` file as h5py 2 wrote it: byte strings
    as fixed-length arrays, optionally the name list split in two."""
    with h5py.File(path, "w") as f:
        f.attrs["keras_version"] = np.bytes_(b"2.10.0")
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        g = f.create_group("model_weights")
        names = np.array([n.encode() for n, _w in layers])
        if split:
            half = len(names) // 2
            g.attrs["layer_names0"] = names[:half]
            g.attrs["layer_names1"] = names[half:]
        else:
            g.attrs["layer_names"] = names
        for lname, ws in layers:
            lg = g.create_group(lname)
            lg.attrs["weight_names"] = (np.array([w.encode() for w, _a in ws])
                                        if ws else np.array([]))
            for wname, arr in ws:
                lg.create_dataset(wname, data=np.asarray(arr, np.float32))


@pytest.mark.parametrize("name", NETS)
def test_import_of_keras2_layout_equals_jax(name, tmp_path):
    """VGG16 at narrow widths here (the importers take any)."""
    trees = ((vgg16_tree(np.random.default_rng(3)),)
             if name == "vgg16_classifier" else keras_fixture_tree(name))
    path = str(tmp_path / f"{name}.h5")
    write_keras2(path, keras2_layers(name, trees))
    want, module = import_both(name, path, trees)
    got = port_trees(name, module)
    assert_trees_equal(got, want)
    assert_trees_equal(got, trees)


@pytest.mark.parametrize("name", ["srcnn", "edsr_x4"])
def test_split_layer_names_do_what_jax_does(name, tmp_path):
    """A split ``layer_names`` is not read, by JAX or the port: both walk
    the groups in ``keys()`` order (alphabetical), so a by-order importer
    meets conv2d, conv2d_1, conv2d_10, ... and gets the same result (here
    a shape error, or the same mis-ordered tree)."""
    path = str(tmp_path / f"{name}.h5")
    write_keras2(path, keras2_layers(name, keras_fixture_tree(name)),
                 split=True)
    try:
        want = import_both(name, path)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            import_both(name, path)
        return
    want, module = want
    assert_trees_equal(port_trees(name, module), want)


def test_wrong_layer_counts_and_shapes_raise_as_jax(tmp_path):
    trees = keras_fixture_tree("edsr_x2")
    layers = keras2_layers("edsr_x2", trees)
    path = str(tmp_path / "short.h5")
    write_keras2(path, layers[:-1])
    params = dict(port_module("edsr_x2", trees).named_parameters())
    with pytest.raises(ValueError, match="expected 8 conv layers, found 7"):
        jki.import_edsr(zeros(trees[0]), path, num_res_blocks=2)
    with pytest.raises(ValueError, match="expected 8 conv layers, found 7"):
        keras_import.import_edsr(params, path, num_res_blocks=2,
                                 device="cpu")
    srcnn = os.path.join(HERE, "srcnn.h5")       # f1 16 into f1 96
    wide = dict(SRCNN(device="cpu").named_parameters())
    msg = r"shape mismatch at conv1: h5 \(9, 9, 3, 16\) vs flax \(9, 9, 3, 96\)"
    with pytest.raises(ValueError, match=msg):
        jki.import_srcnn(bridge.to_flax_tree(wide), srcnn)
    with pytest.raises(ValueError, match=msg):
        keras_import.import_srcnn(wide, srcnn, device="cpu")
    gen = keras_fixture_tree("esrgan_generator")
    bad = [(n, w) for n, w in keras2_layers("esrgan_generator", gen)
           if n != "trunk_conv"]
    write_keras2(path, bad)
    gparams = dict(port_module("esrgan_generator", gen).named_parameters())
    with pytest.raises(ValueError, match="matched 28 of 29 conv layers"):
        keras_import.import_esrgan_generator(gparams, path, device="cpu")
