"""The port's lifecycle facades (``tpusr_torch.models.api``), as
``tests/test_api.py`` drives the JAX ones: setup -> fit -> evaluate ->
super_resolve / classify -> save -> restore through the ``arch`` sidecar into
a facade set up with other defaults; each inference method equal to the
function it wraps called directly; Keras ``.h5`` export and import against
the JAX package's importers; a directory that is not an Orbax checkpoint
refused by name (Orbax checkpoints themselves: ``tests/test_torch_orbax.py``)."""

import numpy as np
import pytest
import torch

import jax
from test_torch_fixtures import vgg_layers, write_notop_h5
from tpusr.models.vgg import load_keras_h5_weights as jload_h5
from tpusr.train import keras_import as jki
from tpusr_torch.bridge import to_flax_tree

from tpusr_torch.models.api import (EDSR, FineTunedVGG16, SRCNNModel,
                                    _saved_arch, augment_classification_set,
                                    module_with_params)
from tpusr_torch.pipeline.defect_pipeline import classify_defects
from tpusr_torch.pipeline.inference import (srcnn_super_resolve,
                                            super_resolve_image)


@pytest.fixture(scope="module")
def sr_pairs():
    rng = np.random.default_rng(0)
    y = rng.random((24, 24, 24, 3), dtype=np.float32)
    x = 0.5 * (y + np.roll(y, 1, axis=1))
    return x, y


def _params_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_srcnn_facade_lifecycle(sr_pairs, tmp_path, capsys):
    x, y = sr_pairs
    with pytest.raises(RuntimeError, match="not been trained"):
        m0 = SRCNNModel(device="cpu")
        m0.setup_model()
        m0.evaluate(x, y)
    m = SRCNNModel(device="cpu")
    m.setup_model(input_shape=(24, 24, 3))
    history, tt, mt = m.fit(x[:16], y[:16], x[16:], y[16:], batch_size=8,
                            epochs=2)
    assert len(history["loss"]) <= 2 and len(tt.epoch_times_sec) <= 2
    loss, psnr, ssim = m.evaluate(x[16:], y[16:])
    assert np.isfinite(psnr) and "PSNR" in capsys.readouterr().out
    lr = np.random.default_rng(1).random((16, 16, 3)).astype(np.float32)
    sr, metrics = m.super_resolve_image(lr, hr_h=32, hr_w=30, patch_size=24,
                                        stride=12)
    want, _ = srcnn_super_resolve(module_with_params(m.module, m.state.params),
                                  lr, 32, 30, patch_size=24, stride=12)
    assert sr.shape == (32, 30, 3) and metrics["time_sec"] > 0
    assert torch.equal(sr, want)
    path = m.save(str(tmp_path), "test")

    m2 = SRCNNModel(device="cpu")
    m2.setup_model(input_shape=(24, 24, 3), from_pretrained=True,
                   pretrained_path=path)
    assert _params_equal(m2.state.params, m.state.params)
    assert m2.state.opt_state["count"] == m.state.opt_state["count"]
    assert abs(m2.evaluate(x[16:], y[16:])[0] - loss) < 1e-6


def test_edsr_facade_lifecycle_and_arch_restore(tmp_path):
    rng = np.random.default_rng(2)
    y = rng.random((24, 16, 16, 3), dtype=np.float32)
    x = y[:, ::2, ::2, :]
    m = EDSR(device="cpu")
    m.setup_model(scale_factor=2, num_res_blocks=2, num_filters=8,
                  learning_rate=1e-3)
    history, _, _ = m.fit(x[:16], y[:16], x[16:], y[16:], batch_size=8,
                          epochs=2)
    assert np.isfinite(history["loss"]).all()
    m.evaluate(x[16:], y[16:])
    lr = rng.random((20, 18, 3)).astype(np.float32)
    sr, _ = m.super_resolve_image(lr, patch_size_lr=8, stride=4)
    assert sr.shape == (40, 36, 3)
    want, _ = super_resolve_image(m.network(), lr, patch_size_lr=8, stride=4,
                                  scale=2)
    assert torch.equal(sr, want)
    path = m.save(str(tmp_path), "t")
    assert _saved_arch(path) == {"scale_factor": 2, "channels": 3,
                                 "num_res_blocks": 2, "num_filters": 8,
                                 "res_scaling": 0.1}

    # restored into a facade set up with other defaults (x4, 16 blocks, 64)
    m2 = EDSR(device="cpu")
    m2.setup_model(scale_factor=4, from_pretrained=True, pretrained_path=path)
    assert m2.scale_factor == 2 and m2.module.num_res_blocks == 2
    assert _params_equal(m2.state.params, m.state.params)
    sr2, _ = m2.super_resolve_image(lr, patch_size_lr=8, stride=4)
    assert torch.equal(sr2, sr)


def test_vgg16_facade_lifecycle_and_arch_restore(tmp_path):
    rng = np.random.default_rng(4)
    x0 = rng.random((8, 32, 32, 3), dtype=np.float32) * 0.3
    x1 = rng.random((8, 32, 32, 3), dtype=np.float32) * 0.3 + 0.7
    x = np.concatenate([x0, x1]).astype(np.float32)
    y = np.array([0] * 8 + [1] * 8)
    m = FineTunedVGG16(device="cpu")
    m.setup_model(input_shape=(32, 32, 3), num_classes=2)
    history = m.fit(x[::2], y[::2], x[1::2], y[1::2], batch_size=8, epochs=1,
                    use_augmentation=True)
    assert "accuracy" in history
    loss, acc = m.evaluate(x[1::2], y[1::2])
    assert np.isfinite(loss)
    img = rng.random((48, 48, 3)).astype(np.float32)
    cls, conf = m.classify_defects_method(img)
    assert cls in (0, 1) and 0.0 <= conf <= 1.0
    assert (cls, conf) == classify_defects(m.network(), img, patch=32,
                                           device="cpu")
    # the base stays frozen: only the head trained
    frozen = module_with_params(m.module, m.trainer.init_state().params)
    trained = m.network()
    assert torch.equal(frozen.vgg16.block5_conv3.weight,
                       trained.vgg16.block5_conv3.weight)
    assert not torch.equal(frozen.fc1.weight, trained.fc1.weight)
    path = m.save(str(tmp_path), "t")

    m2 = FineTunedVGG16(device="cpu")
    m2.setup_model(from_pretrained=True, pretrained_path=path)  # 128x128 default
    assert m2.input_shape == (32, 32, 3)
    assert _params_equal(m2.state.params, m.state.params)
    assert m2.classify_defects_method(img) == (cls, conf)


def test_paths_not_ported_yet_raise_naming_their_item(tmp_path):
    """Each facade's ``save_h5`` writes what JAX's importer reads back as
    the facade's weights, and ``from_pretrained`` on that ``.h5`` restores
    them; a directory that is not an Orbax checkpoint is refused by name
    (the facades' Orbax round trips: ``tests/test_torch_orbax.py``); a
    Keras notop
    ``.h5`` of ImageNet weights loads as JAX's loader does."""
    cases = ((SRCNNModel, {}, lambda t, p: jki.import_srcnn(t, p)),
             (EDSR, {"num_res_blocks": 1, "num_filters": 8},
              lambda t, p: jki.import_edsr(t, p, num_res_blocks=1)),
             (FineTunedVGG16, {"input_shape": (32, 32, 3)},
              lambda t, p: jki.import_vgg16_classifier(t, p)))
    for facade, kw, jax_import in cases:
        m = facade(device="cpu")
        m.setup_model(**kw)
        g = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for v in m.state.params.values():     # non-zero biases too
                v.add_(0.01 * torch.randn(v.shape, generator=g))
        m.trained = m._trained = True
        h5 = m.save_h5(str(tmp_path), "t")
        tree = to_flax_tree(m.state.params)
        back = jax.tree.map(np.asarray, jax_import(
            jax.tree.map(np.zeros_like, tree), h5))
        assert jax.tree.all(jax.tree.map(np.array_equal, back, tree))
        m2 = facade(device="cpu")
        m2.setup_model(from_pretrained=True, pretrained_path=h5, **kw)
        assert _params_equal(m2.state.params, m.state.params)
        with pytest.raises(ValueError, match="not an Orbax checkpoint"):
            m.setup_model(from_pretrained=True, pretrained_path=str(tmp_path),
                          **kw)       # a directory without _METADATA
    layers = vgg_layers("vgg16", seed=1)
    notop = write_notop_h5(tmp_path / "vgg16_notop.h5", layers)
    m = FineTunedVGG16(device="cpu")
    m.setup_model(input_shape=(32, 32, 3), imagenet_weights_path=notop)
    template = {"vgg16": {n: {k: np.zeros_like(a) for k, a in v.items()}
                          for n, v in layers.items()}}
    want = jload_h5(template, notop, "vgg16")["vgg16"]
    got = to_flax_tree(m.state.params)["vgg16"]
    assert all(np.array_equal(got[n][k], np.asarray(want[n][k]))
               for n in want for k in ("kernel", "bias"))
    # a mesh is taken now (tests/test_torch_dist_*.py); what is not a
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        EDSR(mesh=object(), device="cpu").setup_model(num_res_blocks=1,
                                                      num_filters=8)
    with pytest.raises(FileNotFoundError):
        EDSR(device="cpu").setup_model(from_pretrained=True,
                                       pretrained_path=str(tmp_path / "none"))


def test_augmentation_shapes():
    x = np.random.default_rng(0).random((6, 16, 16, 3)).astype(np.float32)
    y = np.arange(6) % 2
    xa, ya = augment_classification_set(x, y, device="cpu")
    assert xa.shape == (12, 16, 16, 3)
    assert (ya[:6] == ya[6:]).all()
    np.testing.assert_array_equal(xa[:6], x)
    assert not np.allclose(xa[:6], xa[6:])   # augmented copies differ
    xb, _ = augment_classification_set(x, y, device="cpu")
    np.testing.assert_array_equal(xa, xb)    # seeded
