"""The port's defect-detection comparison (``run_defect_detection_comparison``,
``classify_defects``, ``make_patch_classifier``,
``FusedSRClassifyPipeline.throughput``; tpusr_torch/pipeline/
defect_pipeline.py) against tpusr/pipeline/defect_pipeline.py on the CPU,
on the narrow networks the gate tests train (tests/test_torch_gate.py) and
the port's hard-task eval images of 128^2."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_gate import (SIZE, _narrow_jax_vgg,  # noqa: F401
                             threads_per_worker, trained)
import tpusr.models.vgg as jvgg
import tpusr.pipeline.defect_pipeline as jdp
from tpusr.core.resize import resize as jax_resize
from tpusr.models import quant as jq
from tpusr.models.edsr_fast import make_fused_sr_apply as jax_fused
from tpusr.models.layers import pixel_shuffle as jax_pixel_shuffle
import tpusr_torch.pipeline.defect_pipeline as tdp
from tpusr_torch.bridge import qtree_from_flax
from tpusr_torch.core.resize import resize
from tpusr_torch.models.edsr_fast import make_fused_sr_apply
from tpusr_torch.models.layers import pixel_shuffle
from tpusr_torch.models.quant import quantized_vgg16_apply

PATCH, STRIDE, BATCH = 96, 48, 3     # 8 images: batches of 3, 3 and 2 (padded)


def _methods(trained):
    """The same SR methods in both packages: cv2-parity bicubic, clipped,
    and the f32 fused-tail EDSR."""
    fj, rj = jax_fused(trained["ev"], 4, dtype=jnp.float32)
    ft, rt = make_fused_sr_apply(trained["edsr"])
    jax_methods = {
        "bicubic": lambda x: jnp.clip(jax_resize(x, (SIZE, SIZE), "bicubic"),
                                      0.0, 1.0),
        "edsr": lambda x: jax_pixel_shuffle(fj(x), rj)}
    port_methods = {
        "bicubic": lambda x: resize(x, (SIZE, SIZE), "bicubic").clamp(0.0, 1.0),
        "edsr": lambda x: pixel_shuffle(ft(x), rt)}
    return jax_methods, port_methods


def _assert_results_match(got, want, conf_atol):
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert set(g) == set(w), name
        np.testing.assert_array_equal(g["predictions"], w["predictions"])
        np.testing.assert_array_equal(g["confusion_matrix"],
                                      w["confusion_matrix"])
        for key in ("accuracy", "error_rate"):
            assert g[key] == w[key], (name, key)
        for key in ("psnr_mean", "ssim_mean"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4,
                                       err_msg=f"{name} {key}")
        np.testing.assert_allclose(g["confidences"], w["confidences"], rtol=0,
                                   atol=conf_atol, err_msg=name)
        for key in ("mean_confidence", "mean_confidence_correct",
                    "mean_confidence_wrong"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=conf_atol,
                                       err_msg=f"{name} {key}")
        assert g["time_sec"] > 0.0


def test_comparison_matches_jax_with_the_f32_classifier(trained, monkeypatch):
    _narrow_jax_vgg(monkeypatch)
    model = jvgg.VGG16Classifier(num_classes=2)
    hr = trained["hr_eval"]
    lr = resize(hr, (SIZE // 4, SIZE // 4), "area").numpy()
    y = trained["y_eval"].numpy()
    jax_methods, port_methods = _methods(trained)
    want = jdp.run_defect_detection_comparison(
        jax_methods, lambda p: model.apply({"params": trained["cv"]}, p), lr,
        hr.numpy(), y, PATCH, STRIDE, BATCH, verbose=False)
    got = tdp.run_defect_detection_comparison(
        port_methods, trained["vgg"], lr, hr.numpy(), y, PATCH, STRIDE, BATCH,
        verbose=False, device="cpu")
    _assert_results_match(got, want, conf_atol=1e-5)
    print({k: (v["accuracy"], round(v["psnr_mean"], 3), v["predictions"].tolist())
           for k, v in got.items()})


def test_comparison_matches_jax_with_the_int8_classifier(trained):
    """The per-patch int8 classifier on JAX's int8 tree, against JAX run op
    by op (under jit XLA's CPU backend makes FMAs that move int8 values),
    behind an SR method both packages compute bit for bit (nearest
    upsampling): float32 ulps between two SR images can move single int8
    inputs across a rounding boundary (ROADMAP.md, queue 3), which would
    hide the classifier's own agreement."""
    hr = trained["hr_eval"]
    lr = resize(hr, (SIZE // 4, SIZE // 4), "area").numpy()
    y = trained["y_eval"].numpy()
    qj = jq.quantize_vgg16(trained["cv"], jq.calibrate_vgg16(
        trained["cv"], jnp.asarray(trained["calib"].numpy())))
    qt = qtree_from_flax(jax.tree.map(np.asarray, qj), device="cpu")
    with jax.disable_jit():
        want = jdp.run_defect_detection_comparison(
            {"nearest": lambda x: jnp.repeat(jnp.repeat(x, 4, 1), 4, 2)},
            lambda p: jq.quantized_vgg16_apply(qj, p), lr, hr.numpy(), y,
            PATCH, STRIDE, BATCH, verbose=False)
    got = tdp.run_defect_detection_comparison(
        {"nearest": lambda x: x.repeat_interleave(4, 1).repeat_interleave(4, 2)},
        lambda p: quantized_vgg16_apply(qt, p), lr, hr.numpy(), y, PATCH,
        STRIDE, BATCH, verbose=False, device="cpu")
    _assert_results_match(got, want, conf_atol=1e-5)


@pytest.mark.parametrize("hw", [(128, 128), (100, 130)])
def test_classify_defects_matches_jax(trained, monkeypatch, hw):
    _narrow_jax_vgg(monkeypatch)
    model = jvgg.VGG16Classifier(num_classes=2)
    cv = trained["cv"]

    def jax_clf(p):
        return model.apply({"params": cv}, p)

    for i in range(3):
        image = trained["hr_eval"][i, :hw[0], :hw[1]].numpy()
        want = jdp.classify_defects(jax_clf, image, PATCH, STRIDE)
        got = tdp.classify_defects(trained["vgg"], image, PATCH, STRIDE,
                                   device="cpu")
        assert isinstance(got[0], int) and isinstance(got[1], float)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    fn = tdp.make_patch_classifier(trained["vgg"], hw, PATCH)
    with pytest.raises(ValueError, match="is not"):
        fn(torch.zeros((hw[0] + 1, hw[1], 3)))


def test_throughput_times_iters_calls_after_a_warm_up():
    calls = []

    def sr_apply(x):
        calls.append(x.shape[0])
        return x.repeat_interleave(2, 1).repeat_interleave(2, 2)

    def clf(p):
        return torch.softmax(p.mean(dim=(1, 2))[:, :2], dim=-1)

    pipe = tdp.FusedSRClassifyPipeline(sr_apply, clf, (24, 24), 2, patch=16,
                                       device="cpu")
    ips = pipe.throughput(np.random.default_rng(0).random((4, 24, 24, 3)),
                          iters=3)
    assert ips > 0.0 and calls == [4] * 4
