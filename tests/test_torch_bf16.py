"""bf16 SR serving in the port against the JAX package on the CPU: K2's bf16
instance (its plain twin) against the Pallas kernel in interpret mode, the
bf16 fused SR forward, and ``make_serving_pipeline(sr_mode="bf16")`` with
the guarded vote_frac cascade.

K2's bf16 contract rounds once, after an fp32 bias add; JAX's bf16 EDSR
rounds the conv and then adds a bf16 bias. The SR images therefore differ
by design, and the port's bf16 SR is held to JAX's by its PSNR against the
f32 SR."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import edsr_tree
from test_torch_pipeline import (CASCADE, LR, PATCH, SCALE, STRIDE,  # noqa: F401
                                 _jax_classify, slice_inputs)
from tpusr.core.pallas_conv import conv3x3_bias_act as pallas_bias_act
from tpusr.models.edsr_fast import make_fused_sr_apply as jax_make_fused
from tpusr.models.layers import pixel_shuffle as jax_pixel_shuffle
from tpusr.pipeline import make_serving_pipeline as jax_make_pipeline
from tpusr_torch.bridge import edsr_from_flax, vgg16_from_flax
from tpusr_torch.core import conv3x3
from tpusr_torch.models.edsr_fast import make_fused_sr_apply
from tpusr_torch.models.layers import pixel_shuffle
from tpusr_torch.pipeline import make_serving_pipeline

K2_SHAPES = [(2, 12, 12, 64, 64), (2, 9, 7, 3, 64), (1, 6, 5, 64, 3),
             (2, 5, 4, 16, 256)]


def bf16_ulps(a, b) -> np.ndarray:
    """Distance in bf16 ulps between two bf16 arrays (torch or numpy bits),
    across zero: the bit patterns mapped onto a monotone integer line."""
    def line(x):
        bits = (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x).view(np.int16)).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(line(a) - line(b))


def _bf16_pair(a: np.ndarray):
    """The same bf16 values for both packages (rounded once, by JAX)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_bf16_twin_within_one_ulp_of_pallas(shape, relu):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape) + relu)
    xj, xt = _bf16_pair(rng.standard_normal((n, h, w, cin)))
    kj, kt = _bf16_pair(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    conv3x3.reset_launch_counts()
    got = conv3x3.conv3x3_bias_act(xt, kt, torch.from_numpy(b), relu)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, h, w, cout)
    want = np.asarray(pallas_bias_act(xj, kj, jnp.asarray(b), relu=relu,
                                      interpret=True))
    assert bf16_ulps(got, want).max() <= 1
    assert sum(conv3x3.LAUNCHES.values()) == 0      # CPU: the plain twin


def _psnr(a, b):
    return float(10.0 * np.log10(1.0 / np.mean((a - b) ** 2)))


def test_bf16_fused_sr_within_half_db_of_jax_bf16():
    rng = np.random.default_rng(40)
    _, params = edsr_tree(rng, SCALE)          # EDSR x4, 2 blocks, 8 filters
    x = rng.random((2, 16, 16, 3), dtype=np.float32)

    def jax_sr(dtype):
        fn, r = jax_make_fused(params, SCALE, dtype=dtype)
        return np.asarray(jax_pixel_shuffle(fn(jnp.asarray(x)), r)
                          .astype(jnp.float32))

    ref, jax_bf16 = jax_sr(jnp.float32), jax_sr(jnp.bfloat16)
    fn, s = make_fused_sr_apply(edsr_from_flax(params, SCALE, device="cpu"),
                                torch.bfloat16)
    with torch.inference_mode():
        y = fn(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16
    port_bf16 = pixel_shuffle(y, s).float().numpy()
    assert port_bf16.shape == ref.shape
    p_port, p_jax = _psnr(port_bf16, ref), _psnr(jax_bf16, ref)
    print(f"bf16 SR PSNR against JAX f32 SR: port {p_port:.3f} dB, "
          f"JAX bf16 {p_jax:.3f} dB")
    assert p_port >= p_jax - 0.5


def _per_patch_class1_votes(pipe, sr):
    probs = pipe.cascade_votes.per_patch_probs(pipe.pre_quant(sr))
    return (probs.argmax(-1) == 1).sum(-1).tolist()


@pytest.mark.parametrize("guard", [0.6, None])
def test_bf16_cascade_pipeline_matches_jax(slice_inputs, guard):
    """The shipped cascade behind bf16 SR. Its classes and confidences equal
    JAX's cascade stage run on the port's own bf16 SR image with the port's
    activation scales. End to end against JAX's bf16 pipeline the SR images
    differ by design (one rounding in K2 against two in JAX), and on this
    slice every image is within a few patch votes of a tie, so classes that
    flip there are printed with both packages' per-patch votes (ROADMAP.md,
    queue 3)."""
    sv, cv, lr, calib = slice_inputs
    kw = dict(patch=PATCH, stride=STRIDE, sr_mode="bf16",
              clf_mode="cascade_int8", calib_patches=calib,
              **{**CASCADE, "cascade_guard_threshold": guard})
    pipe = make_serving_pipeline(
        edsr_from_flax(sv, SCALE, device="cpu"), vgg16_from_flax(cv, device="cpu"),
        (LR, LR), SCALE, device="cpu", **kw)
    jpipe = jax_make_pipeline(sv, cv, (LR, LR), SCALE, **kw)
    conv3x3.reset_launch_counts()
    for n_valid in (8, 5):
        sr, cls, conf = pipe(lr, n_valid=n_valid)
        assert sr.dtype == torch.float32 and sr.shape == (8, LR * SCALE, LR * SCALE, 3)
        cls_r, conf_r = map(np.asarray, _jax_classify(
            pipe, sr, cv, "cascade_int8", n_valid, guard))
        np.testing.assert_array_equal(cls.numpy(), cls_r)
        np.testing.assert_allclose(conf.numpy(), conf_r, atol=1e-6, rtol=0)
        assert (pipe.cascade_votes.last_escalated < n_valid).all()

        sr_j, cls_j, _ = map(np.asarray, jpipe(lr, n_valid=n_valid))
        flips = np.flatnonzero(cls.numpy() != cls_j).tolist()
        print(f"guard={guard} n_valid={n_valid}: SR PSNR port bf16 vs JAX "
              f"bf16 {_psnr(sr.numpy(), sr_j):.2f} dB; {len(flips)} of 8 "
              f"classes differ from JAX's bf16 pipeline {flips}; class-1 "
              f"per-patch votes of 16, port "
              f"{_per_patch_class1_votes(pipe, sr)}, JAX on its SR "
              f"{_per_patch_class1_votes(pipe, torch.from_numpy(sr_j.copy()))}")
    assert sum(conv3x3.LAUNCHES.values()) == 0
