"""``python -m tpusr_torch.cli convert`` (mirrors tests/test_cli_convert.py):
each of the four models from a Keras ``.h5`` to the port's checkpoint and
back to ``.h5``, on the CPU. The source files are the JAX exporter's
fixtures where the facade's architecture is theirs (EDSR, the
discriminator, VGG16) and the port's exports of seeded weights otherwise
(SRCNN at 96/32, the generator at 64 filters); the last file, read by
JAX's importers, holds the source's weights bit for bit. ``--disc`` is
refused on a checkpoint source; ``--model`` and ``--src`` are required. A
JAX facade's Orbax checkpoint converts to the ``.h5`` that JAX's
``convert`` writes from it."""

import os

import jax
import numpy as np
import pytest

from test_torch_cli import narrow_models
from test_torch_fixtures import keras_fixture_tree, seeded_tree
from test_torch_keras import fixture_path
from tpusr.models import ESRGANGenerator, SRCNN
from tpusr.train import keras_import as jki
from tpusr_torch.cli.__main__ import main
from tpusr_torch.train import keras_export


def _equal(got, want):
    got = jax.tree.map(np.asarray, got)
    assert jax.tree.all(jax.tree.map(np.array_equal, got, want))


def _zeros(tree):
    return jax.tree.map(np.zeros_like, tree)


def _convert(argv, src, tmp_path):
    """src .h5 -> checkpoint -> .h5; returns the last file's path(s)."""
    ckpt = main(["convert", *argv, "--src", src, "--out",
                 str(tmp_path / "ckpt"), "--timestamp", "t0",
                 "--device", "cpu"])
    return main(["convert", *argv, "--src", ckpt, "--out",
                 str(tmp_path / "h5"), "--timestamp", "t1",
                 "--device", "cpu"])


def test_convert_srcnn_h5_ckpt_h5_roundtrip(tmp_path):
    (params,) = seeded_tree(SRCNN(), (1, 24, 24, 3), seed=21)
    src = str(tmp_path / "SRCNN_ref.h5")
    keras_export.export_srcnn(params, src)
    out = _convert(["--model", "srcnn"], src, tmp_path)
    assert out == str(tmp_path / "h5" / "SRCNN_t1.h5")
    _equal(jki.import_srcnn(_zeros(params), out), params)


def test_convert_edsr_h5_ckpt_h5_roundtrip(tmp_path):
    src = fixture_path("edsr_x2", tmp_path)
    out = _convert(["--model", "edsr", "--scale", "2", "--blocks", "2",
                    "--filters", "8"], src, tmp_path)
    (params,) = keras_fixture_tree("edsr_x2")
    _equal(jki.import_edsr(_zeros(params), out, num_res_blocks=2), params)


def test_convert_esrgan_h5_ckpt_h5_roundtrip(tmp_path, monkeypatch):
    """The generator and the discriminator (``--disc``) in; both out. The
    facade's perceptual VGG19, which convert does not touch, is narrowed."""
    narrow_models(monkeypatch)
    gen = ESRGANGenerator(scale_factor=2, growth_channels=4,
                          num_rrdb_blocks=1)
    (g_params,) = seeded_tree(gen, (1, 8, 8, 3), seed=22)
    src = str(tmp_path / "ESRGAN_generator_ref.h5")
    keras_export.export_esrgan_generator(g_params, src)
    disc = fixture_path("esrgan_discriminator", tmp_path)
    argv = ["--model", "esrgan", "--scale", "2", "--growth", "4",
            "--rrdb-blocks", "1", "--patch-size", "12"]
    ckpt = main(["convert", *argv, "--src", src, "--disc", disc, "--out",
                 str(tmp_path / "ckpt"), "--timestamp", "t0",
                 "--device", "cpu"])
    g_out, d_out = main(["convert", *argv, "--src", ckpt, "--out",
                         str(tmp_path / "h5"), "--timestamp", "t1",
                         "--device", "cpu"])
    assert os.path.basename(g_out) == "ESRGAN_generator_x2_t1.h5"
    assert os.path.basename(d_out) == "ESRGAN_discriminator_x2_t1.h5"
    _equal(jki.import_esrgan_generator(_zeros(g_params), g_out), g_params)
    d_params, spectral = keras_fixture_tree("esrgan_discriminator")
    _equal(jki.import_esrgan_discriminator(_zeros(d_params),
                                           _zeros(spectral), d_out),
           (d_params, spectral))
    with pytest.raises(SystemExit, match="--disc only applies"):
        main(["convert", *argv, "--src", ckpt, "--disc", disc,
              "--device", "cpu"])


def test_convert_vgg16_h5_ckpt_h5_roundtrip(tmp_path):
    src = fixture_path("vgg16_classifier", tmp_path)
    out = _convert(["--model", "vgg16", "--input-hw", "96"], src, tmp_path)
    (params,) = keras_fixture_tree("vgg16_classifier")
    _equal(jki.import_vgg16_classifier(_zeros(params), out), params)


def test_convert_requires_model_and_src(capsys):
    with pytest.raises(SystemExit):
        main(["convert", "--model", "srcnn"])  # --src missing
    with pytest.raises(SystemExit):
        main(["convert", "--src", "x.h5"])  # --model missing


def _h5_datasets(path) -> dict:
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_convert_takes_a_jax_orbax_checkpoint(tmp_path):
    """``convert --src`` a JAX facade's Orbax checkpoint (EDSR x2, its Adam
    moments not zero) writes the ``.h5`` that JAX's ``convert`` writes from
    it: every dataset equal."""
    import tpusr.cli.__main__ as jcli
    import tpusr.models.api as japi

    je = japi.EDSR()
    je.setup_model(scale_factor=2, num_res_blocks=1, num_filters=8)
    x = np.random.default_rng(4).random((2, 8, 8, 3), dtype=np.float32)
    je.state, _ = je.trainer.train_step(je.state, x, np.repeat(
        np.repeat(x, 2, axis=1), 2, axis=2))
    je.trained = True
    src = je.save(str(tmp_path / "jax"), "t0")
    argv = ["convert", "--model", "edsr", "--src", src, "--timestamp", "t1"]
    jcli.main(argv + ["--out", str(tmp_path / "j")])
    got = main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert os.path.basename(got) == "EDSR_x2_t1.h5"
    want = _h5_datasets(tmp_path / "j" / "EDSR_x2_t1.h5")
    have = _h5_datasets(got)
    assert sorted(have) == sorted(want) and want
    for k, w in want.items():
        assert np.array_equal(have[k], w), k
