"""The port's serving slice end to end against the JAX package:
make_serving_pipeline in the shipped mode (f32 EDSR x4 -> guarded vote_frac
int8 cascade), in the per-patch and shared-trunk modes, with int8 SR, its
defaults, classify_chunks, the f32 reference path of ``entry()``, the
PipelineServer, and the device rule of the entry points."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import (center_classifier_bias, edsr_tree, to_numpy,
                                 vgg16_tree)
import tpusr.pipeline.cascade as jcasc
from tpusr.core.pad import pad_amounts
from tpusr.core.patches import patchify
from tpusr.models import VGG16Classifier as JaxVGG16
from tpusr.models import quant as jq
from tpusr.models.edsr_fast import make_fused_sr_apply as jax_make_fused
from tpusr.models.layers import pixel_shuffle as jax_pixel_shuffle
from tpusr.models import EDSR as JaxEDSR
from tpusr.models.vgg_trunk import shared_trunk_probs_f32 as jax_trunk_f32
from tpusr.models.vgg_trunk import shared_trunk_probs_int8 as jax_trunk
from tpusr.pipeline import FusedSRClassifyPipeline as JaxPipeline
from tpusr.pipeline import make_serving_pipeline as jax_make_pipeline
from tpusr.pipeline.defect_pipeline import _vote as jax_vote
from tpusr_torch.bridge import edsr_from_flax, vgg16_from_flax
from tpusr_torch.core import conv3x3
from tpusr_torch.entry import entry, entry_pipeline
from tpusr_torch.models import EDSR, VGG16Classifier, block1
from tpusr_torch.models.vgg_trunk import shared_trunk_probs_f32
from tpusr_torch.pipeline import (FusedSRClassifyPipeline, PipelineServer,
                                  make_serving_pipeline)

LR, SCALE, PATCH, STRIDE = 16, 4, 32, 16   # 64x64 SR, 4x4 patch grid
CASCADE = dict(cascade_escalate_frac=0.25, cascade_escalate_score="vote_frac",
               cascade_guard_threshold=0.6)


def _jax_per_patch_probs(q, sr):
    srq = sr if sr.dtype == jnp.int8 else jq.quantize_input(q, sr)
    pad_h, pad_w = pad_amounts(srq.shape[1], srq.shape[2], PATCH, STRIDE)
    padded = jnp.pad(srq, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                     mode="reflect")
    patches = jnp.concatenate([patchify(im, PATCH, STRIDE) for im in padded])
    probs = jq.quantized_vgg16_apply(q, patches)
    return probs.reshape(srq.shape[0], -1, probs.shape[-1])


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.default_rng(7)
    _, sv = edsr_tree(rng, SCALE)
    lr = rng.random((8, LR, LR, 3), dtype=np.float32)
    fn, r = jax_make_fused(sv, SCALE, dtype=jnp.float32)
    sr = jax_pixel_shuffle(fn(jnp.asarray(lr)), r)
    calib = np.asarray(sr[:2]).reshape(-1, PATCH, PATCH, 3)[:8]
    cv = vgg16_tree(rng)
    q0 = jq.quantize_vgg16(cv, jq.calibrate_vgg16(cv, calib))
    # center on both paths' patch log-odds, so the trunk's and the per-patch
    # votes both split
    probs = np.concatenate([np.asarray(jax_trunk(q0, sr, PATCH, STRIDE)),
                            np.asarray(_jax_per_patch_probs(q0, sr))])
    return sv, center_classifier_bias(cv, probs), lr, calib


def _port_pipeline(sv, cv, clf_mode, calib, **kw):
    return make_serving_pipeline(
        edsr_from_flax(sv, SCALE, device="cpu"), vgg16_from_flax(cv, device="cpu"),
        (LR, LR), SCALE, patch=PATCH, stride=STRIDE, sr_mode="f32",
        clf_mode=clf_mode, calib_patches=calib, device="cpu", **kw)


def _jax_pipeline(sv, cv, clf_mode, calib, **kw):
    return jax_make_pipeline(sv, cv, (LR, LR), SCALE, patch=PATCH,
                             stride=STRIDE, sr_mode="f32", clf_mode=clf_mode,
                             calib_patches=calib, **kw)


def _jax_classify(pipe, sr, cv, clf_mode, n_valid=None, guard=0.6):
    """The classify stage of JAX's make_serving_pipeline on the port's SR
    image, with the port pipeline's activation scales, run op by op.

    End to end, two things move a few int8 values (ROADMAP.md, queue 3):
    SR images that differ by a few ulps, which can put an input on the
    other side of a rounding boundary (JAX's own jitted and op-by-op SR
    do that too), and activation scales that differ by ulps (each is the
    max of an f32 forward summed in another order). On the same SR image
    with the same scales, JAX and the port round each step as quant.py is
    written."""
    with jax.disable_jit():
        qtree = jq.quantize_vgg16(cv, pipe.qtree["act_scales"])
        srq = jq.quantize_input(qtree, jnp.asarray(sr.numpy()))
        if clf_mode == "cascade_int8":
            return jcasc.make_cascade_votes(qtree, PATCH, STRIDE, 0.25,
                                            "vote_frac", guard)(srq, n_valid)
        if clf_mode == "shared_trunk_int8":
            probs = jax_trunk(qtree, srq, PATCH, STRIDE)
        else:
            probs = _jax_per_patch_probs(qtree, srq)
        return jax.vmap(jax_vote)(probs)


def _compare(got, want, want_on_port_sr):
    """SR to 1e-5 and classes equal end to end; confidences to 1e-6 where
    both packages classify the same SR image. (End to end, SR differences of
    a few ulps can move an int8 input across a rounding boundary: ROADMAP.md,
    queue 3.)"""
    sr_t, cls_t, conf_t = (t.numpy() for t in got)
    sr_j, cls_j, _ = map(np.asarray, want)
    assert sr_t.shape == (8, LR * SCALE, LR * SCALE, 3)
    np.testing.assert_allclose(sr_t, sr_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cls_t, cls_j)
    cls_r, conf_r = map(np.asarray, want_on_port_sr)
    np.testing.assert_array_equal(cls_t, cls_r)
    np.testing.assert_allclose(conf_t, conf_r, atol=1e-6, rtol=0)
    return cls_t


@pytest.mark.parametrize("guard", [0.6, None])
def test_cascade_slice_matches_jax(slice_inputs, guard):
    """The shipped mode (guard 0.6; it trips on this near-50/50 batch, so the
    whole batch is served per-patch) and its unguarded merge path."""
    sv, cv, lr, calib = slice_inputs
    kw = {**CASCADE, "cascade_guard_threshold": guard}
    pipe = _port_pipeline(sv, cv, "cascade_int8", calib, **kw)
    jpipe = _jax_pipeline(sv, cv, "cascade_int8", calib, **kw)
    conv3x3.reset_launch_counts()
    for n_valid in (8, 5):
        got = pipe(lr, n_valid=n_valid)
        cls = _compare(got, jpipe(lr, n_valid=n_valid),
                       _jax_classify(pipe, got[0], cv, "cascade_int8", n_valid,
                                     guard))
        assert len(np.unique(cls)) == 2            # votes split
        assert (pipe.cascade_votes.last_escalated < n_valid).all()
    assert pipe.cascade_votes.guard_trips == (2 if guard else 0)
    assert sum(conv3x3.LAUNCHES.values()) == 0     # CPU: plain twins only


@pytest.mark.parametrize("clf_mode", ["per_patch_int8", "shared_trunk_int8"])
def test_int8_modes_match_jax(slice_inputs, clf_mode):
    sv, cv, lr, calib = slice_inputs
    pipe = _port_pipeline(sv, cv, clf_mode, calib)
    got = pipe(lr)
    _compare(got, _jax_pipeline(sv, cv, clf_mode, calib)(lr),
             _jax_classify(pipe, got[0], cv, clf_mode))


def test_per_patch_f32_matches_jax():
    """The reference-parity mode at full VGG16 width (f32 VGG16Classifier)."""
    rng = np.random.default_rng(6)
    _, sv = edsr_tree(rng, SCALE)
    cv = to_numpy(JaxVGG16(num_classes=2).init(
        jax.random.PRNGKey(6), jnp.zeros((1, PATCH, PATCH, 3)))["params"])
    lr = rng.random((2, LR, LR, 3), dtype=np.float32)
    pipe = _port_pipeline(sv, cv, "per_patch_f32", None)
    sr_t, cls_t, conf_t = (t.numpy() for t in pipe(lr))
    sr_j, cls_j, conf_j = map(np.asarray,
                              _jax_pipeline(sv, cv, "per_patch_f32", None)(lr))
    np.testing.assert_allclose(sr_t, sr_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(conf_t, conf_j, atol=1e-6, rtol=0)


def test_factory_defaults_and_refusals_match_jax(slice_inputs):
    """make_serving_pipeline takes JAX's parameter names and defaults (int8
    SR, int8 shared trunk, 'conf' cascade score, no guard, no mesh);
    ``device`` is the port's own. Missing calibration input and unknown
    modes raise as JAX's do."""
    def defaults(fn, skip):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not p.empty and k != skip}

    assert defaults(make_serving_pipeline, "device") == defaults(
        jax_make_pipeline, None)
    sv, cv, _, calib = slice_inputs
    edsr = edsr_from_flax(sv, SCALE, device="cpu")
    vgg = vgg16_from_flax(cv, device="cpu")
    for match, kw in (("calib_lr", dict(sr_mode="int8", clf_mode="per_patch_f32")),
                      ("calib_patches", dict(sr_mode="f32",
                                             clf_mode="per_patch_int8")),
                      ("clf_mode", dict(sr_mode="f32", clf_mode="nope")),
                      ("sr_mode", dict(sr_mode="nope"))):
        with pytest.raises(ValueError, match=match):
            make_serving_pipeline(edsr, vgg, (LR, LR), SCALE, patch=PATCH,
                                  stride=STRIDE, device="cpu", **kw)


def test_shared_trunk_f32_matches_jax(slice_inputs):
    """f32 convs summed in another order than XLA's: probabilities within
    1e-5, classes equal."""
    sv, cv, lr, _ = slice_inputs
    pipe = _port_pipeline(sv, cv, "shared_trunk_f32", None)
    sr_t, cls_t, conf_t = (t.numpy() for t in pipe(lr))
    sr_j, cls_j, conf_j = map(np.asarray,
                              _jax_pipeline(sv, cv, "shared_trunk_f32", None)(lr))
    np.testing.assert_allclose(sr_t, sr_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(conf_t, conf_j, atol=1e-5, rtol=0)
    vgg = vgg16_from_flax(cv, device="cpu")
    with torch.inference_mode():
        got = shared_trunk_probs_f32(vgg, torch.from_numpy(sr_j.copy()),
                                     PATCH, STRIDE).numpy()
    want = np.asarray(jax_trunk_f32(cv, jnp.asarray(sr_j), PATCH, STRIDE))
    assert got.shape == want.shape == (8, 16, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("clf_mode", ["per_patch_int8", "per_patch_f32"])
def test_classify_chunks_equal_unchunked(slice_inputs, clf_mode):
    sv, cv, lr, calib = slice_inputs
    pipe = _port_pipeline(sv, cv, clf_mode, calib)
    stage = ({"per_patch_probs": pipe.per_patch_probs}
             if clf_mode == "per_patch_int8" else {"clf_apply": pipe.clf_apply})

    def chunked(n):
        return FusedSRClassifyPipeline(
            pipe.sr_apply, lr_hw=(LR, LR), scale=SCALE, patch=PATCH,
            stride=STRIDE, classify_chunks=n, pre_quant=pipe.pre_quant,
            device="cpu", **stage)

    block1.reset_launch_counts()
    whole = chunked(1)(lr)
    for got, want in zip(chunked(4)(lr), whole):
        assert torch.equal(got, want)
    for got, want in zip(whole, pipe(lr)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        chunked(3)(lr)
    assert block1.LAUNCHES["block1_int8"] == 0


# bench.py's int8-SR frontier rows: (sr_border_correction, clf_mode)
INT8_SR_ROWS = {"int8_sr_per_patch_int8": (True, "per_patch_int8"),
                "int8_sr_shared_trunk_int8": (True, "shared_trunk_int8"),
                "int8_sr_noborder_shared_trunk_int8": (False, "shared_trunk_int8")}


@pytest.mark.parametrize("row", sorted(INT8_SR_ROWS))
def test_int8_sr_modes_match_jax(slice_inputs, row):
    """sr_mode='int8' end to end, each side calibrating on the same LR batch.
    SR against JAX's pipeline run op by op (under jit XLA contracts the
    dequant into FMAs; ROADMAP.md, queue 3): the interior within 1e-6 (the
    composed tail's W_eff, built in float64 here and in f32 by JAX, moves
    its rescale and bias by ulps) and the border band within the bf16
    tolerance of tests/test_torch_edsr_quant.py. Classes and confidences are
    held exactly to JAX's classify stage on the port's own SR image; the
    end-to-end class flips against JAX are printed."""
    from test_torch_edsr_quant import BAND_ATOL
    sv, cv, lr, calib = slice_inputs
    border, clf_mode = INT8_SR_ROWS[row]
    kw = dict(sr_mode="int8", clf_mode=clf_mode, calib_lr=lr[:4],
              calib_patches=calib, sr_border_correction=border)
    pipe = make_serving_pipeline(
        edsr_from_flax(sv, SCALE, device="cpu"), vgg16_from_flax(cv, device="cpu"),
        (LR, LR), SCALE, patch=PATCH, stride=STRIDE, device="cpu", **kw)
    sr, cls, conf = (t.numpy() for t in pipe(lr))
    jpipe = jax_make_pipeline(sv, cv, (LR, LR), SCALE, patch=PATCH,
                              stride=STRIDE, **kw)
    with jax.disable_jit():
        sr_j, cls_j, _ = map(np.asarray, jpipe(lr))
    pad = 3
    band = np.ones(sr.shape, bool)
    band[:, SCALE * pad:-SCALE * pad, SCALE * pad:-SCALE * pad] = False
    np.testing.assert_allclose(sr[~band], sr_j[~band], atol=1e-6, rtol=0)
    d = np.abs(sr - sr_j)[band]
    assert d.max() <= (BAND_ATOL if border else 1e-6)
    cls_r, conf_r = map(np.asarray, _jax_classify(
        pipe, torch.from_numpy(sr), cv, clf_mode))
    np.testing.assert_array_equal(cls, cls_r)
    np.testing.assert_allclose(conf, conf_r, atol=1e-6, rtol=0)
    print(f"{row}: SR interior max|d| {np.abs(sr - sr_j)[~band].max():.3g}, "
          f"band max|d| {d.max():.3g}; class flips against JAX's pipeline "
          f"{np.flatnonzero(cls != cls_j).tolist()} of 8")


def test_entry_pipeline_matches_jax_entry_graph():
    """``entry()``'s graph (chained EDSR x4, per-patch f32 VGG16, the vote)
    on JAX-initialised weights through the bridge, at a small LR size,
    against the same graph built as __graft_entry__.entry() builds it."""
    rng = np.random.default_rng(8)
    sr_model = JaxEDSR(scale_factor=SCALE, num_res_blocks=2, num_filters=8)
    sv = to_numpy(sr_model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, LR, LR, 3)))["params"])
    clf_model = JaxVGG16(num_classes=2)
    cv = to_numpy(clf_model.init(jax.random.PRNGKey(1),
                                 jnp.zeros((1, PATCH, PATCH, 3)))["params"])
    lr = rng.random((2, LR, LR, 3), dtype=np.float32)
    jpipe = JaxPipeline(
        sr_apply=lambda x: sr_model.apply({"params": sv}, x),
        clf_apply=lambda p: clf_model.apply({"params": cv}, p),
        lr_hw=(LR, LR), scale=SCALE, patch=PATCH, stride=STRIDE)
    sr_j, cls_j, conf_j = map(np.asarray, jpipe(lr))
    pipe = entry_pipeline(edsr_from_flax(sv, SCALE, device="cpu"),
                          vgg16_from_flax(cv, device="cpu"), (LR, LR), PATCH,
                          STRIDE, device="cpu")
    sr_t, cls_t, conf_t = (t.numpy() for t in pipe(lr))
    np.testing.assert_allclose(sr_t, sr_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(conf_t, conf_j, atol=1e-6, rtol=0)


def test_entry_builds_the_reference_graph_at_full_size(monkeypatch):
    """entry() at its real size, built but not run (a full-size forward on
    the CPU takes minutes): the example batch, the device rule and the
    seeded weights."""
    fn, (lr,) = entry(device="cpu")
    assert tuple(lr.shape) == (2, 128, 128, 3) and lr.dtype == torch.float32
    np.testing.assert_array_equal(
        lr.numpy(), np.random.default_rng(0).random((2, 128, 128, 3),
                                                    dtype=np.float32))
    pipe = fn.pipeline
    assert (pipe.patch, pipe.stride, pipe.scale, pipe.n_patches) == (96, 48, 4, 100)
    assert pipe.sr_apply.num_res_blocks == 16
    ref = EDSR(scale_factor=4, device="cpu",
               key=0)
    assert torch.equal(pipe.sr_apply.head.kernel, ref.head.kernel)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_server_matches_direct_calls(slice_inputs):
    sv, cv, lr, calib = slice_inputs
    pipe = _port_pipeline(sv, cv, "cascade_int8", calib, **CASCADE)
    imgs = lr[:7]                      # 7 requests at batch 4: one partial
    with PipelineServer(pipe, batch_size=4, max_wait_ms=200) as server:
        results = [f.result(timeout=120)
                   for f in [server.submit(im) for im in imgs]]
    # the server's batches are the direct calls on the same padded batches,
    # with the pad rows marked by n_valid
    for start, n in ((0, 4), (4, 3)):
        batch = np.concatenate([imgs[start:start + n],
                                np.repeat(imgs[start + n - 1:start + n], 4 - n, 0)])
        sr, cls, conf = pipe(batch, n_valid=n)
        for i in range(n):
            r = results[start + i]
            assert r["class"] == int(cls[i])
            assert r["confidence"] == float(conf[i])
            np.testing.assert_array_equal(r["sr"], sr[i].numpy())


def test_server_error_propagation_and_stop():
    def broken(_):
        raise RuntimeError("boom")

    with PipelineServer(broken, batch_size=2, max_wait_ms=5) as server:
        with pytest.raises(RuntimeError, match="boom"):
            server.submit(np.zeros((LR, LR, 3), np.float32)).result(timeout=30)
    server = PipelineServer(broken, batch_size=2)
    fut = server.submit(np.zeros((LR, LR, 3), np.float32))
    server.stop()                      # never started: pending futures fail
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(np.zeros((LR, LR, 3), np.float32))


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EDSR(scale_factor=4, num_res_blocks=1, num_filters=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VGG16Classifier(widths=(8, 8, 8, 8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedSRClassifyPipeline(lambda x: x, clf_apply=lambda p: p,
                                lr_hw=(LR, LR), scale=SCALE)
    edsr = EDSR(scale_factor=4, num_res_blocks=1, num_filters=8, device="cpu")
    vgg = VGG16Classifier(widths=(8, 8, 8, 8, 8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_pipeline(edsr, vgg, (LR, LR), SCALE, patch=PATCH,
                              stride=STRIDE, sr_mode="f32",
                              clf_mode="per_patch_f32")
    # and TF32 is off whenever a device is resolved
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
