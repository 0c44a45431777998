"""The port's int8 EDSR (tpusr_torch/models/edsr_quant.py) against
tpusr/models/edsr_quant.py on the CPU, EDSR x4 with 2 blocks of 8 filters.

The JAX forward is run op by op: each f32 step then rounds on its own, as
edsr_quant.py is written and as the port computes. (Under ``jit`` XLA's CPU
backend contracts the dequant's multiply and add into one FMA, which moves
the interior SR by up to ~0.15 on these random weights; ROADMAP.md, queue 3.)
The port's border band runs the chained tail through K2's bf16 instance,
which rounds once where JAX's bf16 conv rounds twice, so the band is held to
a bf16 tolerance and the interior exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import edsr_tree, to_numpy
from tpusr.models import edsr_quant as jeq
from tpusr_torch.bridge import edsr_from_flax, edsr_qtree_from_flax
from tpusr_torch.core import conv3x3
from tpusr_torch.models import edsr_quant as teq
from tpusr_torch.models.edsr_fast import make_fused_sr_apply

SCALE = 4
BAND_ATOL = 0.125          # 16 bf16 ulps at 1.0: three chained bf16 convs
BAND_MIN_PSNR = 40.0       # over the band cells, port against JAX


@pytest.fixture(scope="module")
def sr_inputs():
    rng = np.random.default_rng(11)
    _, params = edsr_tree(rng, SCALE)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    scales = jeq.calibrate_edsr(params, x)
    qj = to_numpy(jeq.quantize_edsr(params, SCALE, scales))
    return params, x, scales, qj


def test_calibration_and_quantization_match_jax(sr_inputs):
    params, x, scales, qj = sr_inputs
    edsr = edsr_from_flax(params, SCALE, device="cpu")
    got = teq.calibrate_edsr(edsr, x)
    assert set(got) == set(scales)
    for name, s in scales.items():
        np.testing.assert_allclose(got[name], s, rtol=1e-6, err_msg=name)
    q = teq.quantize_edsr(edsr, scales)
    assert q["pad"] == qj["pad"] and q["n_res"] == qj["n_res"]
    assert set(q["layers"]) == set(qj["layers"])
    tail_kq_diff = 0
    for name, lj in qj["layers"].items():
        lt = q["layers"][name]
        # the port keeps the 3x3 convs' K-major kernels beside JAX's keys
        packed = {"kernel_packed"} if lj["kernel_q"].shape[0] == 3 else set()
        assert set(lt) == set(lj) | packed, name
        if packed:
            assert torch.equal(lt["kernel_packed"],
                               conv3x3.pack_int8_kernel(lt["kernel_q"])), name
        diff = int((lt["kernel_q"].numpy() != lj["kernel_q"]).sum())
        if name == "tail":
            # W_eff: float64 impulse probe here, f32 HIGHEST in JAX; a
            # kernel_q value could round across .5 (none does on this tree)
            tail_kq_diff = diff
            np.testing.assert_allclose(lt["rescale"].numpy(), lj["rescale"],
                                       rtol=1e-6)
            np.testing.assert_allclose(lt["bias"].numpy(), lj["bias"],
                                       rtol=0, atol=1e-6)
        else:
            assert diff == 0, name
            for key in lj:
                np.testing.assert_array_equal(lt[key].numpy(), lj[key],
                                              err_msg=f"{name}.{key}")
    print(f"tail kernel_q values differing from JAX's: {tail_kq_diff} of "
          f"{qj['layers']['tail']['kernel_q'].size}")
    assert tail_kq_diff == 0


@pytest.mark.parametrize("int8_carry", [False, True])
@pytest.mark.parametrize("border", [True, False])
def test_int8_sr_on_jax_tree_matches_jax(sr_inputs, border, int8_carry):
    params, x, scales, qj = sr_inputs
    fj, s = jeq.make_fused_sr_apply_int8(params, SCALE, act_scales=scales,
                                         border_correction=border,
                                         int8_carry=int8_carry)
    with jax.disable_jit():
        want = np.asarray(fj(jnp.asarray(x)))
    edsr = edsr_from_flax(params, SCALE, device="cpu")
    fn, s_t = teq.make_fused_sr_apply_int8(
        edsr, qtree=edsr_qtree_from_flax(qj, device="cpu"),
        border_correction=border, int8_carry=int8_carry)
    assert s_t == s
    conv3x3.reset_launch_counts()
    with torch.inference_mode():
        got = fn(torch.from_numpy(x))
    assert sum(conv3x3.LAUNCHES.values()) == 0       # CPU: the plain twins
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    pad = qj["pad"]
    band = np.ones(got.shape, bool)
    band[:, pad:-pad, pad:-pad] = False
    np.testing.assert_array_equal(got[~band], want[~band])
    d = np.abs(got - want)[band]
    psnr = 10 * np.log10(1.0 / max(float(np.mean(d ** 2)), 1e-30))
    print(f"border={border} int8_carry={int8_carry}: interior equal; band "
          f"max|d| {d.max():.4g}, {int((d > 0).sum())} of {d.size} differ, "
          f"PSNR {psnr:.1f} dB")
    if border:
        assert d.max() <= BAND_ATOL and psnr >= BAND_MIN_PSNR
    else:
        assert d.max() == 0.0


def test_int8_sr_tracks_f32_sr(sr_inputs):
    """The port's own calibration end to end, as the JAX package's
    test_int8_sr_tracks_f32 holds its int8 SR (random weights are the
    hardest case for PTQ)."""
    params, x, _, _ = sr_inputs
    edsr = edsr_from_flax(params, SCALE, device="cpu")
    fq, _ = teq.make_fused_sr_apply_int8(edsr, sample_lr=x)
    ff, _ = make_fused_sr_apply(edsr)
    with torch.inference_mode():
        a, b = fq(torch.from_numpy(x)), ff(torch.from_numpy(x))
    psnr = 10 * np.log10(1.0 / float(((a - b) ** 2).mean()))
    assert psnr > 30.0, psnr
    with pytest.raises(ValueError, match="calib"):
        teq.make_fused_sr_apply_int8(edsr)


def test_tail_conv_int8_equals_plain_twin():
    rng = np.random.default_rng(5)
    x8 = torch.from_numpy(rng.integers(-127, 128, (2, 9, 11, 64), dtype=np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (7, 7, 64, 48), dtype=np.int8))
    got = teq.tail_conv_int8(x8, kq)
    assert got.dtype == torch.int32 and got.shape == (2, 9, 11, 48)
    assert torch.equal(got, teq.tail_conv_int8_plain(x8, kq))
