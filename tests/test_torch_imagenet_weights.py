"""The port's ImageNet-weights tool (``tpusr_torch/tools/imagenet_weights.py``)
and the facades that load it, against the JAX package's on seeded random
bundles in the converted layout and on Keras notop ``.h5`` files written
here in the official releases' layout (no download).

Tolerances: the loaded backbone equals the bundle exactly (HWIO -> OIHW);
``FineTunedVGG16`` logits and the ``ESRGAN`` facade's VGG19 features within
1e-5 of the JAX facades' on the same bundle and input. The networks are
narrowed in both packages (``narrow_models``).
"""

import json
import shutil

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
from test_torch_cli import narrow_models
from test_torch_fixtures import (NARROW_WIDTHS, vgg16_tree, vgg_layers,
                                 write_notop_h5)
from tpusr.models.vgg import VGG16Classifier as JaxVGG16Classifier
from tpusr.models.vgg import VGG19Features as JaxVGG19Features
from tpusr.models.vgg import load_keras_h5_weights as jload_h5
from tpusr.tools import imagenet_weights as jtool
from tpusr_torch.bridge import vgg16_from_flax
from tpusr_torch.models.api import ESRGAN, FineTunedVGG16
from tpusr_torch.tools import imagenet_weights as tool

ATOL = 1e-5


def _bundle(path, arch, widths=None, seed=0):
    """A converted bundle (``block{b}_conv{c}/kernel`` HWIO and ``/bias``)
    of random weights; at ``widths`` per block when given."""
    flat = {"__arch__": np.asarray(arch)}
    for name, leaves in vgg_layers(arch, seed, widths).items():
        for leaf, a in leaves.items():
            flat[f"{name}/{leaf}"] = a
    np.savez(path, **flat)
    return str(path)


@pytest.mark.parametrize("arch", ["vgg16", "vgg19"])
def test_expected_shapes_and_validate_match_jax(arch, tmp_path):
    assert tool.expected_shapes(arch) == jtool.expected_shapes(arch)
    layers = tool.npz_layers(_bundle(tmp_path / "w.npz", arch))
    tool.validate(arch, layers)
    jtool.validate(arch, layers)
    bad = dict(layers)
    del bad["block1_conv2"]
    with pytest.raises(ValueError, match="missing conv layers"):
        tool.validate(arch, bad)
    bad = {**layers, "block2_conv1": {**layers["block2_conv1"],
                                      "kernel": layers["block2_conv1"]["kernel"][..., :-1]}}
    with pytest.raises(ValueError, match="block2_conv1: kernel shape"):
        tool.validate(arch, bad)


def test_fine_tuned_vgg16_loads_the_npz_as_jax(tmp_path, monkeypatch):
    """The port's facade on the bundle against what JAX's facade computes:
    ``load_backbone_weights`` into a params tree, then the classifier. The
    heads are each package's own draws, so the JAX tree's head is given to
    the port."""
    narrow_models(monkeypatch)
    npz = _bundle(tmp_path / "vgg16.npz", "vgg16", NARROW_WIDTHS)
    tree = vgg16_tree(np.random.default_rng(5), dense_units=256)
    params = jtool.load_backbone_weights(tree, npz, "vgg16")
    m = FineTunedVGG16(device="cpu")
    m.setup_model(input_shape=(32, 32, 3), imagenet_weights_path=npz)
    for layer, leaves in tool.npz_layers(npz).items():
        np.testing.assert_array_equal(
            m.state.params[f"vgg16.{layer}.weight"].permute(2, 3, 1, 0).numpy(),
            leaves["kernel"])
        np.testing.assert_array_equal(
            m.state.params[f"vgg16.{layer}.bias"].numpy(), leaves["bias"])
    head = vgg16_from_flax(tree, device="cpu").state_dict()
    mixed = {k: (v if k.startswith("vgg16.") else head[k])
             for k, v in m.state.params.items()}
    x = np.random.default_rng(1).random((3, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jax.jit(JaxVGG16Classifier().apply)(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = functional_call(m.module, mixed, (torch.from_numpy(x),))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_esrgan_facade_loads_vgg19_from_the_npz_as_jax(tmp_path, monkeypatch):
    """The ``ESRGAN`` facade's perceptual extractor on the bundle against
    JAX's ``load_backbone_weights`` + ``VGG19Features``."""
    narrow_models(monkeypatch)
    npz = _bundle(tmp_path / "vgg19.npz", "vgg19", NARROW_WIDTHS, seed=2)
    m = ESRGAN(device="cpu")
    m.setup_model(growth_channels=4, num_rrdb_blocks=1, input_shape=(8, 8, 3),
                  output_shape=(16, 16, 3), vgg19_weights_path=npz)
    tree = {"vgg19": {layer: {leaf: np.zeros(a.shape, np.float32)
                              for leaf, a in leaves.items()}
                      for layer, leaves in tool.npz_layers(npz).items()}}
    params = jtool.load_backbone_weights(tree, npz, "vgg19")["vgg19"]
    x = np.random.default_rng(3).random((2, 16, 16, 3), dtype=np.float32) * 255
    want = np.asarray(jax.jit(JaxVGG19Features().apply)(
        {"params": {"vgg19": params}}, jnp.asarray(x)))
    with torch.no_grad():
        got = functional_call(m.vgg_model, m.trainer.vgg_params,
                              (torch.from_numpy(x),))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=ATOL * np.abs(want).max())


def test_a_layer_the_backbone_lacks_or_a_wrong_shape_raises(tmp_path, monkeypatch):
    narrow_models(monkeypatch)
    npz16 = _bundle(tmp_path / "vgg16.npz", "vgg16", NARROW_WIDTHS)
    vgg19 = _bundle(tmp_path / "vgg19.npz", "vgg19", NARROW_WIDTHS)
    full = _bundle(tmp_path / "full.npz", "vgg16")
    m = FineTunedVGG16(device="cpu")
    with pytest.raises(ValueError, match="unexpected layer block3_conv4"):
        m.setup_model(input_shape=(32, 32, 3), imagenet_weights_path=vgg19)
    with pytest.raises(ValueError, match="block1_conv1/kernel: shape"):
        m.setup_model(input_shape=(32, 32, 3), imagenet_weights_path=full)
    m.setup_model(input_shape=(32, 32, 3), imagenet_weights_path=npz16)


def test_hdf5_paths_raise_naming_the_item(tmp_path, monkeypatch):
    """The ``.h5`` half against JAX's on a notop file in the official
    layout: ``h5_backbone_arrays`` gives JAX's arrays, ``convert`` JAX's
    ``.npz``, ``main`` validates it (and refuses a wrong architecture as
    JAX does), and ``load_backbone_weights`` fills the backbone as JAX's
    does a flax tree."""
    narrow_models(monkeypatch)
    layers = vgg_layers("vgg16", seed=3)
    h5 = write_notop_h5(tmp_path / "vgg16_notop.h5", layers)
    got, want = tool.h5_backbone_arrays(h5), jtool.h5_backbone_arrays(h5)
    assert got.keys() == want.keys() == layers.keys()
    for name in want:
        for leaf in ("kernel", "bias"):
            assert np.array_equal(got[name][leaf], want[name][leaf])
            assert np.array_equal(got[name][leaf], layers[name][leaf])
    tool.convert("vgg16", h5, str(tmp_path / "port.npz"))
    jtool.convert("vgg16", h5, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    tool.main(["--arch", "vgg16", "--src", h5])
    for main in (tool.main, jtool.main):
        with pytest.raises(ValueError, match="vgg19: missing conv layers"):
            main(["--arch", "vgg19", "--src", h5])
    narrow = write_notop_h5(tmp_path / "narrow.h5",
                            vgg_layers("vgg16", 4, NARROW_WIDTHS))
    m = FineTunedVGG16(device="cpu")
    m.setup_model(input_shape=(32, 32, 3), imagenet_weights_path=narrow)
    tree = {"vgg16": {n: {k: np.zeros_like(a) for k, a in leaves.items()}
                      for n, leaves in vgg_layers("vgg16", 4,
                                                  NARROW_WIDTHS).items()}}
    for name, leaves in jload_h5(tree, narrow, "vgg16")["vgg16"].items():
        np.testing.assert_array_equal(
            m.state.params[f"vgg16.{name}.weight"].permute(2, 3, 1, 0).numpy(),
            np.asarray(leaves["kernel"]))
        np.testing.assert_array_equal(
            m.state.params[f"vgg16.{name}.bias"].numpy(),
            np.asarray(leaves["bias"]))


def test_keras1_weight_names_do_what_jax_does(tmp_path):
    """A notop file with Keras 1 names (``block1_conv1_W_1:0``, no '/'):
    JAX's ``h5_backbone_arrays`` keys each array by its whole name under the
    layer, and ``validate`` then finds no 'kernel' (KeyError); the port
    does the same (a fault of the reference, ROADMAP queue 3)."""
    h5 = write_notop_h5(tmp_path / "keras1.h5", vgg_layers("vgg16", 5),
                        keras1_names=True)
    got, want = tool.h5_backbone_arrays(h5), jtool.h5_backbone_arrays(h5)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys() == {
            f"{name}_W_1", f"{name}_b_1"}
        assert all(np.array_equal(got[name][k], want[name][k])
                   for k in want[name])
    for validate, arrays in ((tool.validate, got), (jtool.validate, want)):
        with pytest.raises(KeyError, match="kernel"):
            validate("vgg16", arrays)


def test_manifest_is_the_jax_packages_and_hashes_match_jax(tmp_path):
    assert tool.load_manifest() == jtool.load_manifest()
    f = tmp_path / "blob.bin"
    f.write_bytes(np.random.default_rng(0).bytes(3 << 20))
    assert tool.file_hashes(str(f)) == jtool.file_hashes(str(f))


def test_verify_official_checks_md5_and_records_sha256(tmp_path, monkeypatch,
                                                       capsys):
    """On a copy of the manifest whose md5 is this file's (a notop file in
    the official layout, seeded weights): the check passes and ``main``
    validates the file, ``--record-sha256`` writes the sha256 once, then
    holds the file to it; another file fails on md5."""
    f = tmp_path / "vgg16_notop.h5"
    write_notop_h5(f, vgg_layers("vgg16", seed=6))
    manifest = tmp_path / "manifest.json"
    shutil.copy(tool.MANIFEST, manifest)
    data = json.loads(manifest.read_text())
    data["vgg16_notop"]["md5"] = tool.file_hashes(str(f))["md5"]
    manifest.write_text(json.dumps(data))
    monkeypatch.setattr(tool, "MANIFEST", str(manifest))
    tool.main(["--arch", "vgg16", "--src", str(f), "--verify-official",
               "--record-sha256"])
    out = capsys.readouterr().out
    assert "md5 OK" in out and "recorded sha256" in out
    assert (json.loads(manifest.read_text())["vgg16_notop"]["sha256"]
            == tool.file_hashes(str(f))["sha256"])
    tool.verify_official(str(f), "vgg16_notop")
    g = tmp_path / "other.h5"
    g.write_bytes(b"another file")
    with pytest.raises(ValueError, match="does not match the official"):
        tool.verify_official(str(g), "vgg16_notop")
    with pytest.raises(KeyError, match="unknown manifest key"):
        tool.verify_official(str(f), "vgg11_notop")
