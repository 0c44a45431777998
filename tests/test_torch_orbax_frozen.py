"""A JAX VGG16 state trained with its base (``base_trainable=True``), so
its frozen-base moments are not zero, restored by the port wherever JAX
restores it: into the frozen-base facade that ``pipeline`` and ``serve``
build, through ``convert``, and by ``--resume`` of a frozen-base trainer,
which holds those moments and decays them by Adam's betas each step as the
JAX trainer's masked step does. Narrow widths on the CPU; the JAX state is
written by the JAX facade's ``save`` (its ``save_checkpoint``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusr.models.api as japi
import tpusr_torch.models.api as tapi
from test_torch_cli import narrow_models
from test_torch_orbax import assert_same_leaves, jax_leaves, port_leaves
from test_torch_train import assert_params_close
from tpusr.train.checkpoint import restore_checkpoint as jax_restore
from tpusr_torch.train import save_checkpoint

HW = 32
STEPS = 2
LR = 1e-3


def _frozen(leaves: dict) -> dict:
    """The moments of the frozen base (``opt_state/{mu,nu}/vgg16/...``)."""
    return {k: v for k, v in leaves.items()
            if k[:2] in (("opt_state", "mu"), ("opt_state", "nu"))
            and k[2] == "vgg16"}


def _batches():
    rng = np.random.default_rng(25)
    x = rng.random((2 * STEPS, 2, HW, HW, 3), dtype=np.float32)
    y = np.array([[0, 1]] * (2 * STEPS), np.int32)
    return x, y


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """(the JAX checkpoint's path, the JAX facade that trained it): VGG16
    at narrow widths, every parameter trained for ``STEPS`` steps."""
    d = tmp_path_factory.mktemp("finetuned")
    x, y = _batches()
    with pytest.MonkeyPatch.context() as mp:
        narrow_models(mp)
        jf = japi.FineTunedVGG16()
        jf.setup_model(input_shape=(HW, HW, 3), num_classes=2,
                       base_trainable=True, train_last_n_layers=0,
                       dropout_rate=0.0, learning_rate=LR)
        for i in range(STEPS):
            jf.state, _ = jf.trainer.train_step(jf.state, jnp.asarray(x[i]),
                                                jnp.asarray(y[i]), i)
        jf.trained = True
        path = jf.save(str(d), "t")
    frozen = _frozen(jax_leaves(jf.state))
    assert frozen and all(np.any(v != 0) for v in frozen.values())
    return path, jf


@pytest.mark.parametrize("command,hw", [("pipeline", 96), ("serve", HW)])
def test_frozen_base_facade_takes_a_finetuned_jax_state(command, hw,
                                                         finetuned,
                                                         monkeypatch):
    """The facade as ``pipeline`` (input 96) and ``serve`` (the patch)
    build it, frozen base, from the checkpoint: every leaf, the frozen
    moments included, equal to the JAX facade's restore, and the same
    classes on a batch of patches."""
    narrow_models(monkeypatch)
    path, _jf = finetuned
    kw = dict(input_shape=(hw, hw, 3), num_classes=2, from_pretrained=True,
              pretrained_path=path)
    tf = tapi.FineTunedVGG16(device="cpu")
    tf.setup_model(**kw)
    jf = japi.FineTunedVGG16()
    jf.setup_model(**kw)
    assert tf.trainer.trainable_predicate(("vgg16", "block1_conv1")) is False
    assert_same_leaves(port_leaves(tf.state), jax_leaves(jf.state))
    x = _batches()[0][-1]
    with torch.no_grad():
        got = tf.network()(torch.from_numpy(x)).numpy()
    want = np.asarray(jf.module.apply({"params": jf.state.params},
                                      jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_convert_takes_a_finetuned_jax_state(finetuned, tmp_path,
                                             monkeypatch):
    """``convert --model vgg16`` of the checkpoint writes an ``.h5`` that
    JAX's importer reads back as JAX's restore of the checkpoint's
    parameters, leaf for leaf (JAX's own ``convert`` builds a full-width
    Keras model, which these narrow weights do not fit)."""
    from tpusr.train import keras_import as jki
    from tpusr_torch.cli.__main__ import main

    narrow_models(monkeypatch)
    path, jf = finetuned
    got = main(["convert", "--model", "vgg16", "--src", path, "--input-hw",
                str(HW), "--timestamp", "t1", "--out", str(tmp_path),
                "--device", "cpu"])
    want = jax_restore(os.path.dirname(path), os.path.basename(path),
                       jax.tree.map(jnp.zeros_like, jf.state)).params
    have = jki.import_vgg16_classifier(jax.tree.map(np.zeros_like, want),
                                       got)
    flat = jax.tree_util.tree_flatten_with_path
    pairs = zip(flat(jax.tree.map(np.asarray, have))[0],
                flat(jax.tree.map(np.asarray, want))[0])
    for (kh, h), (kw, w) in pairs:
        assert kh == kw and np.array_equal(h, w), kw


def test_resume_of_a_frozen_base_trainer_decays_the_frozen_moments(
        finetuned, tmp_path, monkeypatch):
    """``--resume`` into ``train-vgg16``'s frozen-base trainer: the port
    keeps the frozen moments, ``STEPS`` more steps decay them as JAX's
    frozen trainer does (bit for bit) and leave the base where it was, the
    head steps as JAX's, and JAX reads the port's save back equal in the
    moments and the base."""
    from tpusr.train import ClassifierTrainer as JaxTrainer
    from tpusr_torch.cli.__main__ import _maybe_resume
    from tpusr_torch.train import ClassifierTrainer

    narrow_models(monkeypatch)
    path, jf = finetuned
    frozen = lambda p: p[0] != "vgg16"  # noqa: E731  (train-vgg16's)
    pt = ClassifierTrainer(tapi.VGG16Classifier(num_classes=2,
                                                dropout_rate=0.0,
                                                device="cpu"),
                           LR, trainable_predicate=frozen, device="cpu")
    args = type("A", (), {"resume": path})()
    st_t = _maybe_resume(args, pt, ())
    jt = JaxTrainer(jf.module, LR, trainable_predicate=frozen)
    st_j = jax_restore(os.path.dirname(path), os.path.basename(path),
                       jax.tree.map(jnp.zeros_like, jf.state))
    assert_same_leaves(port_leaves(st_t), jax_leaves(st_j))
    x, y = _batches()
    for i in range(STEPS, 2 * STEPS):
        st_j, _ = jt.train_step(st_j, jnp.asarray(x[i]), jnp.asarray(y[i]), i)
        st_t, _ = pt.train_step(st_t, torch.from_numpy(x[i]),
                                torch.from_numpy(y[i]).long(), i)
    got, want = port_leaves(st_t), jax_leaves(st_j)
    moved = _frozen(want)
    assert_same_leaves(_frozen(got), moved)
    before = _frozen(jax_leaves(jf.state))
    assert all(not np.array_equal(moved[k], before[k]) for k in moved)
    for k, w in want.items():
        if k[0] == "params" and k[1] == "vgg16":
            assert np.array_equal(got[k], w), k
    head = [k for k in want if k[0] == "params" and k[1] != "vgg16"]
    assert_params_close({k: got[k] for k in head},
                        {k: want[k] for k in head}, STEPS, LR)
    saved = save_checkpoint(str(tmp_path), "port", st_t)
    back = jax_restore(str(tmp_path), "port",
                       jax.tree.map(jnp.zeros_like, st_j))
    assert_same_leaves(_frozen(jax_leaves(back)), moved)
    assert os.path.isdir(saved)
