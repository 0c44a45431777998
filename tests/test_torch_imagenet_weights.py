"""The port's ImageNet-weights tool (``tpusr_torch/tools/imagenet_weights.py``,
its ``.npz`` half) and the facades that load it, against the JAX package's
on seeded random bundles in the converted layout (no download).

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
from test_torch_fixtures import NARROW_WIDTHS, vgg16_tree
from tpusr.models.vgg import VGG16Classifier as JaxVGG16Classifier
from tpusr.models.vgg import VGG19Features as JaxVGG19Features
from tpusr.tools import imagenet_weights as jtool
from tpusr_torch.bridge import vgg16_from_flax
from tpusr_torch.models.api import ESRGAN, FineTunedVGG16
from tpusr_torch.tools import imagenet_weights as tool

ATOL = 1e-5


def _bundle(path, arch, widths=None, seed=0):
    """A converted bundle (``block{b}_conv{c}/kernel`` HWIO and ``/bias``)
    of random weights; at ``widths`` per block when given."""
    rng = np.random.default_rng(seed)
    flat, cin = {"__arch__": np.asarray(arch)}, 3
    for b, n, f in tool._CFGS[arch]:
        f = widths[b - 1] if widths else f
        for c in range(1, n + 1):
            flat[f"block{b}_conv{c}/kernel"] = (rng.standard_normal(
                (3, 3, cin, f)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
            flat[f"block{b}_conv{c}/bias"] = (
                rng.standard_normal(f) * 0.1).astype(np.float32)
            cin = f
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


def test_hdf5_paths_raise_naming_the_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 10: a Keras-HDF5"):
        tool.h5_backbone_arrays("w.h5")
    with pytest.raises(NotImplementedError, match="item 10"):
        tool.convert("vgg16", "w.h5", str(tmp_path / "o.npz"))
    with pytest.raises(NotImplementedError, match="item 10"):
        tool.load_backbone_weights(None, "w.h5", "vgg16")
    with pytest.raises(NotImplementedError, match="item 10"):
        tool.main(["--arch", "vgg16", "--src", "w.h5"])


def test_manifest_is_the_jax_packages_and_hashes_match_jax(tmp_path):
    assert tool.load_manifest() == jtool.load_manifest()
    f = tmp_path / "blob.bin"
    f.write_bytes(np.random.default_rng(0).bytes(3 << 20))
    assert tool.file_hashes(str(f)) == jtool.file_hashes(str(f))


def test_verify_official_checks_md5_and_records_sha256(tmp_path, monkeypatch,
                                                       capsys):
    """On a copy of the manifest whose md5 is this file's: the check
    passes, ``--record-sha256`` writes the sha256 once, then holds the file
    to it; another file fails on md5. No HDF5 is read."""
    f = tmp_path / "vgg16_notop.h5"
    f.write_bytes(b"not really an h5, only hashed")
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
