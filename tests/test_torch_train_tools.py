"""The port's training tools against the JAX package's and against their
own contracts: augmentation (tpusr_torch/data/augment.py, the mirror of
tests/test_augment.py plus the warp against JAX's for the same parameters),
prefetching (the mirror of tests/test_prefetch.py), checkpoints (the mirror
of tests/test_checkpoint_async.py without a mesh, plus the in-place-update
hazards), the callbacks, the metrics logger and VGG16's dropout."""

import os
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusr.data.augment import affine_warp as jax_affine_warp
from tpusr_torch.core import prng
from tpusr_torch.data.augment import (affine_warp, apply_augment,
                                      draw_augment_params, random_augment_batch)
from tpusr_torch.data.prefetch import prefetch_iterator
from tpusr_torch.models import SRCNN, VGG16Classifier
from tpusr_torch.train import (EarlyStopping, EpochMemoryTracker,
                               EpochTimeTracker, ReduceLROnPlateau,
                               SupervisedSRTrainer, load_metadata,
                               restore_checkpoint, save_checkpoint,
                               save_checkpoint_async)
from tpusr_torch.train import checkpoint as ckpt_mod
from tpusr_torch.train.logging import MetricsLogger, jsonl_to_csv, read_jsonl

WARP_ATOL = 1e-5    # float32 bilinear weights; JAX's warp is one rounding
                    # per op, as the port's


def _gen(seed):
    return prng.PRNGKey(seed)


# ------------------------------------------------------------- augmentation

WARP_CASES = [(96, 96, 17.3, 5.2, -8.1), (64, 80, -19.9, 12.0, 3.5),
              (33, 47, 0.0, 0.0, 0.0), (96, 96, 8.0, -19.2, 19.2),
              (50, 50, 0.0, 7.0, -3.0), (41, 96, -5.5, 0.0, 0.0)]


@pytest.mark.parametrize("case", WARP_CASES)
def test_affine_warp_matches_jax_for_the_same_parameters(case):
    h, w, theta, tx, ty = case
    img = np.random.default_rng(h + w).random((h, w, 3)).astype(np.float32)
    want = np.asarray(jax_affine_warp(jnp.asarray(img), theta, tx, ty))
    got = affine_warp(torch.from_numpy(img), theta, tx, ty)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, rtol=0)


def test_batched_warp_and_flip_equal_per_image_jax_warps():
    rng = np.random.default_rng(3)
    x = rng.random((5, 24, 28, 3)).astype(np.float32)
    theta, tx, ty, flip = draw_augment_params(_gen(1), 5, 24, 28)
    got = apply_augment(torch.from_numpy(x), theta, tx, ty, flip).numpy()
    for i in range(5):
        want = np.asarray(jax_affine_warp(jnp.asarray(x[i]), float(theta[i]),
                                          float(tx[i]), float(ty[i])))
        if flip[i]:
            want = want[:, ::-1]
        np.testing.assert_allclose(got[i], want, atol=WARP_ATOL, rtol=0)


def test_identity_params_are_identity():
    img = np.random.default_rng(1).random((24, 24, 3)).astype(np.float32)
    out = affine_warp(torch.from_numpy(img), 0.0, 0.0, 0.0).numpy()
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_random_augment_batch_shapes_range_and_determinism():
    x = torch.from_numpy(np.random.default_rng(2).random((8, 32, 32, 3))
                         .astype(np.float32))
    out = random_augment_batch(_gen(0), x)
    assert out.shape == x.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert float((out - x).abs().max()) > 1e-3
    assert torch.equal(out, random_augment_batch(_gen(0), x))
    assert float((out - random_augment_batch(_gen(1), x)).abs().max()) > 1e-3


def test_random_params_stay_in_the_keras_ranges():
    theta, tx, ty, flip = draw_augment_params(_gen(4), 4096, 50, 80)
    assert float(theta.abs().max()) <= 20.0 and float(theta.abs().max()) > 19.0
    assert float(tx.abs().max()) <= 0.2 * 50 and float(ty.abs().max()) <= 0.2 * 80
    assert 0.45 < float(flip.float().mean()) < 0.55
    # whole-pixel shift ranges are taken as pixels, not fractions
    _, tx2, _, _ = draw_augment_params(_gen(4), 256, 50, 80,
                                       height_shift_range=3.0)
    assert float(tx2.abs().max()) <= 50 * 3.0
    _, _, _, no_flip = draw_augment_params(_gen(4), 64, 8, 8,
                                           horizontal_flip=False)
    assert not bool(no_flip.any())


def test_hflip_applied_after_warp():
    img = np.random.default_rng(4).random((16, 16, 3)).astype(np.float32)
    batch = torch.from_numpy(img[None].repeat(256, 0))
    out = random_augment_batch(_gen(5), batch, rotation_range=0.0,
                               width_shift_range=0.0,
                               height_shift_range=0.0).numpy()
    flipped = np.abs(out - img[None, :, ::-1]).max(axis=(1, 2, 3)) < 1e-6
    kept = np.abs(out - img[None]).max(axis=(1, 2, 3)) < 1e-6
    assert (flipped | kept).all()
    assert 64 < flipped.sum() < 192


# ----------------------------------------------------------------- dropout

def test_dropout_mask_rate_scale_and_generator():
    vgg = VGG16Classifier(widths=(4, 4, 4, 4, 4), dense_units=4,
                          device="cpu", dropout_rate=0.2)
    x = torch.full((2000, 50), 2.0)
    y = vgg._dropout(x, True, _gen(0), 0)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 2.0 / 0.8, rtol=0)  # x / keep
    assert torch.equal(y, vgg._dropout(x, True, _gen(0), 0))
    assert not torch.equal(y, vgg._dropout(x, True, _gen(1), 0))
    # the second Dropout's scope has a key of its own
    assert not torch.equal(y, vgg._dropout(x, True, _gen(0), 1))
    assert vgg._dropout(x, False, None, 0) is x
    with pytest.raises(ValueError, match="dropout_rng"):
        vgg._dropout(x, True, None, 0)


def test_vgg_train_forward_differs_only_by_dropout():
    vgg = VGG16Classifier(widths=(4, 4, 4, 8, 8), dense_units=8, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).random((6, 32, 32, 3),
                                                         dtype=np.float32))
    ev = vgg(x)
    tr = vgg(x, train=True, dropout_rng=_gen(2))
    assert not torch.equal(ev, tr)
    np.testing.assert_allclose(tr.sum(-1).numpy(), 1.0, rtol=1e-6)
    off = VGG16Classifier(widths=(4, 4, 4, 8, 8), dense_units=8, device="cpu",
                          dropout_rate=0.0)
    off.load_state_dict(vgg.state_dict())
    assert torch.equal(off(x, train=True, dropout_rng=_gen(2)), ev)


# ---------------------------------------------------------------- prefetch

def test_order_preserved_and_lazy_bound():
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    it = prefetch_iterator(gen(), depth=4)
    assert [next(it) for _ in range(10)] == list(range(10))
    assert len(produced) <= 10 + 4 + 2
    assert list(it) == list(range(10, 50))


def test_generator_exception_reraises_at_consumer():
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    it = prefetch_iterator(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_depth_zero_is_direct_iteration():
    assert list(prefetch_iterator((i for i in range(3)), depth=0)) == [0, 1, 2]


def test_abandoned_consumer_unblocks_reader():
    before = threading.active_count()
    it = prefetch_iterator(iter(range(100000)), depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def _srcnn_trainer(lr=1e-3):
    return SupervisedSRTrainer(SRCNN(f1=4, f2=2, device="cpu"),
                               learning_rate=lr, device="cpu")


def test_fit_history_identical_with_prefetch():
    rng = np.random.default_rng(0)
    x = rng.random((10, 8, 8, 3), np.float32)
    y = rng.random((10, 8, 8, 3), np.float32)
    hists = [_srcnn_trainer().fit(x[:8], y[:8], x[8:], y[8:], batch_size=4,
                                  epochs=2, verbose=False,
                                  prefetch=depth).history for depth in (0, 3)]
    for k in ("loss", "val_loss", "psnr"):
        assert hists[0][k] == hists[1][k], k


# -------------------------------------------------------------- checkpoints

def test_async_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.int32), "c": [0.5, 3]}
    h = save_checkpoint_async(str(tmp_path), "ck", tree, metadata={"k": 1})
    path = h.wait(60)
    assert h.done() and path.endswith("ck") and os.path.isdir(path)
    got = restore_checkpoint(str(tmp_path), "ck", tree)
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"], tree["b"])
    assert got["b"].dtype == torch.int32 and got["c"] == [0.5, 3]
    assert load_metadata(str(tmp_path), "ck") == {"k": 1}


def test_async_save_snapshot_is_isolated_from_in_place_updates(tmp_path):
    """The trainers update their tensors in place: an update right after the
    call must not reach the checkpoint (a host copy is taken first)."""
    x = torch.ones((256, 256))
    h = save_checkpoint_async(str(tmp_path), "iso", {"x": x})
    x.mul_(0.0)
    h.wait(60)
    got = restore_checkpoint(str(tmp_path), "iso", {"x": x})
    assert float(got["x"].sum()) == 256 * 256


def test_async_save_error_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file, not a directory")
    h = save_checkpoint_async(str(blocker / "sub"), "ck", {"x": torch.ones(3)})
    with pytest.raises(Exception):
        h.wait(60)


def test_restore_refuses_a_mismatched_target(tmp_path):
    save_checkpoint(str(tmp_path), "ck", {"x": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), "ck", {"x": torch.ones(4)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), "ck", {"y": torch.ones(3)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), "ck", {})


def test_fit_periodic_checkpoints_restore_the_whole_state(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.random((10, 8, 8, 3), np.float32)
    y = rng.random((10, 8, 8, 3), np.float32)
    tr = _srcnn_trainer()
    tr.fit(x[:8], y[:8], x[8:], y[8:], batch_size=4, epochs=3, verbose=False,
           checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert (tmp_path / "epoch_0002").exists()
    assert not (tmp_path / "epoch_0003").exists()
    meta = load_metadata(str(tmp_path), "epoch_0002")
    assert meta["epoch"] == 2 and np.isfinite(meta["val_loss"])
    template = tr.init_state()
    restored = restore_checkpoint(str(tmp_path), "epoch_0002", template)
    assert restored.opt_state["count"] == 4            # 2 epochs x 2 batches
    assert all(v.requires_grad for v in restored.params.values())
    assert not torch.equal(restored.params["conv1.weight"],
                           template.params["conv1.weight"])
    ev = tr.eval_step(restored, torch.from_numpy(x[8:]), torch.from_numpy(y[8:]))
    np.testing.assert_allclose(float(ev["loss"]), meta["val_loss"], rtol=1e-6)
    restored, m = tr.train_step(restored, torch.from_numpy(x[:4]),
                                torch.from_numpy(y[:4]))
    assert np.isfinite(float(m["loss"])) and restored.opt_state["count"] == 5


def test_fit_checkpoint_offset_continues_numbering(tmp_path):
    x = np.random.default_rng(3).random((8, 8, 8, 3), np.float32)
    _srcnn_trainer().fit(x[:6], x[:6], x[6:], x[6:], batch_size=4, epochs=2,
                         verbose=False, checkpoint_dir=str(tmp_path),
                         checkpoint_every=1, checkpoint_offset=10)
    names = sorted(d for d in os.listdir(tmp_path) if not d.endswith(".json"))
    assert names == ["epoch_0011", "epoch_0012"], names
    assert load_metadata(str(tmp_path), "epoch_0012")["epoch"] == 12


def test_fit_surfaces_periodic_save_failure(tmp_path, monkeypatch):
    real_write = ckpt_mod._write
    calls = {"n": 0}

    def failing_write(path, leaves, metadata):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full (injected)")
        return real_write(path, leaves, metadata)

    monkeypatch.setattr(ckpt_mod, "_write", failing_write)
    x = np.random.default_rng(4).random((8, 8, 8, 3), np.float32)
    with pytest.raises(OSError, match="disk full"):
        _srcnn_trainer().fit(x[:6], x[:6], x[6:], x[6:], batch_size=4,
                             epochs=4, verbose=False, es_patience=10,
                             plateau_patience=10,
                             checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert calls["n"] >= 2


# ---------------------------------------------------------------- callbacks

def test_early_stopping_and_plateau_semantics():
    es = EarlyStopping(patience=2)
    stops = [es.update(v, state=v) for v in [1.0, 0.9, 0.95, 0.96]]
    assert stops == [False, False, False, True] and es.best_state == 0.9
    pl = ReduceLROnPlateau(factor=0.5, patience=2, min_lr=1e-4)
    lr = pl.update(1.0, 1e-2)
    lr = pl.update(1.1, lr)
    assert lr == 1e-2
    assert pl.update(1.2, lr) == 5e-3
    pl2 = ReduceLROnPlateau(factor=0.5, patience=1, min_lr=1e-4)
    lr = pl2.update(1.0, 1e-2)
    assert pl2.update(1.0 - 5e-5, lr) == 5e-3
    pl3 = ReduceLROnPlateau(factor=0.5, patience=1, min_lr=4e-3)
    pl3.update(1.0, 5e-3)
    assert pl3.update(2.0, 5e-3) == 4e-3                 # floored at min_lr


def test_early_stopping_keeps_a_copy_of_updated_parameters():
    params = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    es = EarlyStopping(patience=2)
    es.update(1.0, params)
    params["w"].add_(5.0)                   # what an in-place step does
    params["b"][0].sub_(1.0)
    assert torch.equal(es.best_state["w"], torch.ones(3))
    assert torch.equal(es.best_state["b"][0], torch.zeros(2))
    assert es.best_state["w"] is not params["w"]


def test_trackers_on_the_cpu():
    tt, mt = EpochTimeTracker(torch.device("cpu")), EpochMemoryTracker("cpu")
    for _ in range(2):
        tt.begin_epoch()
        mt.begin_epoch()
        tt.end_epoch()
        mt.end_epoch()
    assert len(tt.epoch_times_sec) == 2 and tt.mean_time_value() >= 0.0
    assert mt.gpu_peak_mb == [None, None]
    assert mt.as_dict() == {"gpu_mean_current_mb": None, "gpu_peak_mb": None}


# ------------------------------------------------------------------ logging

def test_metrics_logger_takes_tensors_and_is_wired_through_fit(tmp_path):
    path = os.path.join(tmp_path, "metrics.jsonl")
    rng = np.random.default_rng(7)
    x = rng.random((10, 8, 8, 3), np.float32)
    with MetricsLogger(path, run_name="t") as logger:
        logger.log_step(0, {"loss": torch.tensor(0.5), "v": torch.arange(3.0)})
        _srcnn_trainer().fit(x[:8], x[:8], x[8:], x[8:], batch_size=4,
                             epochs=2, verbose=False, metrics_logger=logger)
    step = read_jsonl(path, scope="step")
    assert step[0]["loss"] == 0.5 and step[0]["v"] == [0.0, 1.0, 2.0]
    recs = read_jsonl(path, scope="epoch")
    assert len(recs) == 2
    assert {"loss", "psnr", "ssim", "val_loss", "lr", "epoch_time_sec"} <= set(recs[0])
    csv_path = os.path.join(tmp_path, "metrics.csv")
    jsonl_to_csv(path, csv_path, scope="epoch")
    assert os.path.exists(csv_path)


def test_classifier_augmentation_and_dropout_streams_are_seeded_by_step():
    """``fold_in(PRNGKey(dropout_seed), step)`` keys dropout and
    ``fold_in(PRNGKey(dropout_seed + 1), step)`` the augmentation: the same
    step repeats exactly, another step differs, and the augmented step
    differs from the plain one."""
    from tpusr_torch.train import ClassifierTrainer

    vgg = VGG16Classifier(widths=(4, 4, 4, 8, 8), dense_units=8, device="cpu")
    tr = ClassifierTrainer(vgg, learning_rate=1e-3, device="cpu")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32))
    y = torch.tensor([0, 1, 1, 0])
    w = torch.ones(4)

    def loss(step, augment):
        _, m = tr._train_step_w(tr.init_state(), x, y, w, step, augment)
        return float(m["loss"])

    assert loss(3, True) == loss(3, True)
    assert loss(3, True) != loss(4, True)
    assert loss(3, True) != loss(3, False)
    assert loss(3, False) == loss(3, False) != loss(4, False)
