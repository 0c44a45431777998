"""Report how far the port's serving slice drifts from the JAX package end to
end, and how far JAX drifts from itself, on the inputs of
tests/test_torch_pipeline.py (EDSR x4 2 blocks 8 filters, narrow VGG16, 8 LR
images of 16x16, patch 32, stride 16), in f32, bf16 and int8 SR; and how many
stored SR pixels of the classic comparison differ by a grey level on the
pairs of tests/test_torch_classic.py. Prints the counts that ROADMAP.md
(queue 3) and PERF.md record. Not a test: it asserts nothing.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_bf16 as B  # noqa: E402
import test_torch_classic as C  # noqa: E402
import test_torch_pipeline as T  # noqa: E402
import torch  # noqa: E402
from tpusr.models import quant as jq  # noqa: E402
from tpusr_torch.bridge import edsr_from_flax, vgg16_from_flax  # noqa: E402
from tpusr_torch.classic.harness import CLASSIC_ALGORITHMS, sr_images  # noqa: E402
from tpusr_torch.pipeline import make_serving_pipeline  # noqa: E402

MODES = ("cascade_int8", "per_patch_int8", "shared_trunk_int8")


def main():
    sv, cv, lr, calib = T.slice_inputs.__wrapped__()
    for mode in MODES:
        kw = T.CASCADE if mode == "cascade_int8" else {}
        sr_t, cls_t, conf_t = (t.numpy() for t in
                               T._port_pipeline(sv, cv, mode, calib, **kw)(lr))
        jpipe = T._jax_pipeline(sv, cv, mode, calib, **kw)
        sr_j, cls_j, conf_j = map(np.asarray, jpipe(lr))
        with jax.disable_jit():
            sr_e, cls_e, conf_e = map(np.asarray, jpipe(lr))
        print(f"{mode}: port vs JAX jit: SR max|d| {np.abs(sr_t - sr_j).max():.3g}, "
              f"class flips {int((cls_t != cls_j).sum())}/{cls_t.size}, conf "
              f"max|d| {np.abs(conf_t - conf_j).max():.3g}; JAX jit vs op by "
              f"op: SR max|d| {np.abs(sr_j - sr_e).max():.3g}, class flips "
              f"{int((cls_j != cls_e).sum())}/{cls_j.size}, conf max|d| "
              f"{np.abs(conf_j - conf_e).max():.3g}")

    port = T._port_pipeline(sv, cv, "per_patch_int8", calib)
    scales_j = jq.calibrate_vgg16(cv, calib)
    scales_t = port.qtree["act_scales"]
    rel = {k: abs(scales_j[k] - scales_t[k]) / scales_j[k] for k in scales_j}
    print(f"activation scales: {sum(r > 0 for r in rel.values())} of "
          f"{len(rel)} differ, max relative {max(rel.values()):.3g}")

    q = jq.quantize_vgg16(cv, scales_j)
    fn, r = T.jax_make_fused(sv, T.SCALE, dtype=jnp.float32)
    sr_jit = jax.jit(lambda x: T.jax_pixel_shuffle(fn(x), r))(jnp.asarray(lr))
    with jax.disable_jit():
        sr_op = T.jax_pixel_shuffle(fn(jnp.asarray(lr)), r)
        q_op = np.asarray(jq.quantize_input(q, sr_op))
    q_jit = np.asarray(jq.quantize_input(q, sr_jit))
    print(f"JAX SR jit vs op by op: max|d| "
          f"{float(jnp.abs(sr_jit - sr_op).max()):.3g}, int8 inputs differing "
          f"{int((q_jit != q_op).sum())} of {q_op.size}")

    def trunk(s):
        return jq.int8_backbone(q, jq.quantize_input(q, s), pool5=False)

    with jax.disable_jit():
        b5_op = np.asarray(trunk(sr_op))
    b5_jit = np.asarray(jax.jit(trunk)(sr_op))
    print(f"JAX int8 trunk on the same SR, jit vs op by op: "
          f"{int((b5_jit != b5_op).sum())} of {b5_op.size} values differ")


    bf16_report(sv, cv, lr, calib)
    int8_sr_report(sv, cv, lr, calib)
    classic_report()


def bf16_report(sv, cv, lr, calib):
    """sr_mode='bf16' cascade: the port against JAX's bf16 pipeline, and
    JAX's bf16 pipeline against its own f32 pipeline, with the per-patch
    class-1 votes (of 16) behind each image's class."""
    for guard in (0.6, None):
        kw = dict(patch=T.PATCH, stride=T.STRIDE, clf_mode="cascade_int8",
                  calib_patches=calib,
                  **{**T.CASCADE, "cascade_guard_threshold": guard})
        pipe = make_serving_pipeline(
            edsr_from_flax(sv, T.SCALE, device="cpu"),
            vgg16_from_flax(cv, device="cpu"), (T.LR, T.LR), T.SCALE,
            sr_mode="bf16", device="cpu", **kw)
        sr_t, cls_t, _ = pipe(lr)
        out = {m: T.jax_make_pipeline(sv, cv, (T.LR, T.LR), T.SCALE, sr_mode=m,
                                      **kw)(lr) for m in ("bf16", "f32")}
        sr_j, cls_j = np.asarray(out["bf16"][0]), np.asarray(out["bf16"][1])
        cls_f = np.asarray(out["f32"][1])
        print(f"bf16 cascade guard={guard}: port vs JAX bf16: SR PSNR "
              f"{B._psnr(sr_t.numpy(), sr_j):.2f} dB, class flips "
              f"{np.flatnonzero(cls_t.numpy() != cls_j).tolist()} of 8, guard "
              f"trips port {pipe.cascade_votes.guard_trips}; JAX bf16 vs JAX "
              f"f32 class flips {np.flatnonzero(cls_j != cls_f).tolist()}; "
              f"class-1 per-patch votes port "
              f"{B._per_patch_class1_votes(pipe, sr_t)}, JAX bf16 SR "
              f"{B._per_patch_class1_votes(pipe, torch.from_numpy(sr_j.copy()))}")


def int8_sr_report(sv, cv, lr, calib):
    """sr_mode='int8' rows: the port against JAX's pipeline run op by op and
    jitted, and JAX's jitted SR against its own op-by-op SR (XLA contracts
    the f32 dequant into FMAs under jit)."""
    pad = 3 * T.SCALE
    for row, (border, mode) in sorted(T.INT8_SR_ROWS.items()):
        kw = dict(patch=T.PATCH, stride=T.STRIDE, sr_mode="int8", clf_mode=mode,
                  calib_lr=lr[:4], calib_patches=calib,
                  sr_border_correction=border)
        pipe = make_serving_pipeline(
            edsr_from_flax(sv, T.SCALE, device="cpu"),
            vgg16_from_flax(cv, device="cpu"), (T.LR, T.LR), T.SCALE,
            device="cpu", **kw)
        sr_t, cls_t, _ = (t.numpy() for t in pipe(lr))
        jpipe = T.jax_make_pipeline(sv, cv, (T.LR, T.LR), T.SCALE, **kw)
        sr_j, cls_j, _ = map(np.asarray, jpipe(lr))
        with jax.disable_jit():
            sr_e, cls_e, _ = map(np.asarray, jpipe(lr))
        inner = (slice(None), slice(pad, -pad), slice(pad, -pad))
        d_op, d_jit = np.abs(sr_t - sr_e), np.abs(sr_j - sr_e)
        print(f"{row}: port vs JAX op by op: SR interior max|d| "
              f"{d_op[inner].max():.3g}, whole max|d| {d_op.max():.3g}, class "
              f"flips {np.flatnonzero(cls_t != cls_e).tolist()}; port vs JAX "
              f"jit class flips {np.flatnonzero(cls_t != cls_j).tolist()}; JAX "
              f"jit vs op by op: SR interior max|d| {d_jit[inner].max():.3g} "
              f"({int((d_jit[inner] > 0).sum())} of {d_jit[inner].size} "
              f"differ), class flips {np.flatnonzero(cls_j != cls_e).tolist()}")


def classic_report():
    """Stored SR values one grey level apart, port against JAX, per pair of
    the classic tests."""
    for seed in (3, 5, 6):
        hr, lr = C.synthetic_pair(seed)
        port = sr_images(torch.from_numpy(hr.astype(np.float32)),
                         torch.from_numpy(lr.astype(np.float32)))
        ref = C._jax_sr_images(hr, lr)
        counts = {a: int((port[a].numpy() != ref[a]).sum())
                  for a in CLASSIC_ALGORITHMS if a != "nlm"}
        nlm = float(np.abs(port["nlm"].numpy() - ref["nlm"]).max())
        print(f"classic pair seed {seed} (HR {C.HR}^2, LR {C.LR}^2): stored "
              f"values one level apart {counts}; NLM max|d| {nlm:.3g}")


if __name__ == "__main__":
    main()
