"""Report how far the port's serving slice drifts from the JAX package end to
end, and how far JAX drifts from itself, on the inputs of
tests/test_torch_pipeline.py (EDSR x4 2 blocks 8 filters, narrow VGG16, 8 LR
images of 16x16, patch 32, stride 16). Prints the counts that ROADMAP.md
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

import test_torch_pipeline as T  # noqa: E402
from tpusr.models import quant as jq  # noqa: E402

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


if __name__ == "__main__":
    main()
