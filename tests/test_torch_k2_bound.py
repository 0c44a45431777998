"""The bound that holds K2-bf16 to its twin (chip_smoke.py
``k2_bf16_tolerance``), on the CPU: it accepts two fp32 summation orders of
the same bf16 conv, each rounded once to bf16, and refuses convs that are
wrong. Also: every CUDA source of the port is registered with the builder,
and every registered name has its source.
"""

import numpy as np
import pytest
import torch

from chip_smoke import CheckFailed, check_k2_bf16, k2_bf16_tolerance
from tpusr_torch.core import _build
from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain

# (N, H, W, Cin, Cout): the EDSR head, the tail, an up slab, a narrow body
SHAPES = [(2, 9, 11, 3, 64), (1, 12, 10, 64, 3), (1, 6, 7, 64, 256),
          (2, 8, 8, 32, 16)]


def _operands(shape, seed):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), np.float32))
    k = torch.from_numpy((rng.standard_normal((3, 3, cin, cout))
                          * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(cout) * 0.5).astype(np.float32))
    return x.bfloat16(), k.bfloat16(), b


def _exact(x, k, b, relu):
    """bf16 of the float64 conv + bias (+ ReLU) on the bf16 values."""
    return conv3x3_bias_act_plain(x.double(), k.double(), b.double(),
                                  relu).bfloat16()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bound_accepts_the_twin_against_float64(shape, relu):
    x, k, b = _operands(shape, sum(shape) + relu)
    y = conv3x3_bias_act_plain(x, k, b, relu)          # fp32 sums, bf16
    yp = _exact(x, k, b, relu)
    assert y.dtype == yp.dtype == torch.bfloat16
    max_ulps, n_over, err = check_k2_bf16(x, k, y, yp)
    assert max_ulps >= 0 and n_over >= 0 and err >= 0.0


def test_bound_is_one_ulp_plus_the_fp32_sum_term():
    x, k, b = _operands((1, 5, 6, 16, 8), 0)
    y = conv3x3_bias_act_plain(x, k, b)
    tol = k2_bf16_tolerance(x, k, y, y)
    s = conv3x3_bias_act_plain(x.double().abs(), k.double().abs(),
                               torch.zeros(8, dtype=torch.float64))
    ulp = tol - 2 * 9 * 16 * 2.0 ** -23 * s
    # the remaining term is one bf16 ulp of |y|: a power of two, 2^-7 |y| at
    # most and more than 2^-8 |y| where |y| is normal
    assert bool((torch.log2(ulp) == torch.log2(ulp).round()).all())
    yd = y.double().abs()
    big = yd > 1e-30
    assert bool((ulp[big] <= yd[big] * 2.0 ** -7).all())
    assert bool((ulp[big] > yd[big] * 2.0 ** -8).all())


def _zero_tap(x, k, b):
    k = k.clone()
    k[1, 2] = 0
    return x, k, b


def _roll_channels(x, k, b):
    return torch.roll(x, 1, dims=-1), k, b


def _drop_bias(x, k, b):
    return x, k, torch.zeros_like(b)


@pytest.mark.parametrize("fault", [_zero_tap, _roll_channels, _drop_bias],
                         ids=["tap_zeroed", "channels_rolled", "bias_dropped"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
def test_bound_refuses_a_wrong_conv(shape, fault):
    x, k, b = _operands(shape, 7 + sum(shape))
    y = conv3x3_bias_act_plain(*fault(x, k, b))
    yp = _exact(x, k, b, False)
    with pytest.raises(CheckFailed, match="beyond"):
        check_k2_bf16(x, k, y, yp)


def test_every_cuda_source_is_registered():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        assert (_build.CSRC / f"{name}.cu").is_file()
