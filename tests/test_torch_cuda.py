"""The port's CUDA kernels (tpusr_torch/csrc/conv3x3.cu) against their plain
twins on the card, at edge shapes the serving path does not reach: Cin and
Cout off the 16-byte vector paths, odd spatial sizes, a single pixel.

These tests need an NVIDIA card with sm_90a and ``nvcc``; without a card
they skip. ``tests/conftest.py`` imports JAX and hides CUDA devices, so on
the card run them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from tpusr_torch.core import conv3x3 as k
from tpusr_torch.device import fp32_math

pytestmark = pytest.mark.cuda

K1_SHAPES = [(3, 5, 7, 16, 8), (2, 9, 9, 64, 3), (1, 7, 5, 3, 64),
             (2, 6, 6, 200, 12), (1, 1, 1, 128, 6), (4, 3, 11, 4, 130)]
K2_SHAPES = [(3, 5, 7, 16, 8), (2, 9, 9, 64, 3), (1, 7, 5, 3, 64),
             (2, 6, 6, 20, 12), (1, 1, 1, 64, 6), (2, 4, 13, 32, 130)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_kernel_bit_exact_with_twin(cuda, shape):
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=cuda,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device=cuda,
                       dtype=torch.int8)
    rs = (torch.rand(cout, generator=g, device=cuda) + 0.5) \
        * (40.0 * 3.0 / (math.sqrt(9 * cin) * 127.0 ** 2))
    b = torch.rand(cout, generator=g, device=cuda) * 20.0 - 9.5
    before = k.LAUNCHES["conv3x3_int8_requant"]
    y = k.conv3x3_int8_requant(x, wq, rs, b)
    assert k.LAUNCHES["conv3x3_int8_requant"] == before + 1
    yp = k.conv3x3_int8_requant_plain(x, wq, rs, b)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), int((y != yp).sum())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_kernel_matches_twin(cuda, shape, relu):
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + relu)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda)
    kern = torch.randn((3, 3, cin, cout), generator=g, device=cuda) \
        / math.sqrt(9 * cin)
    b = torch.randn(cout, generator=g, device=cuda) * 0.1
    before = k.LAUNCHES["conv3x3_bias_act"]
    y = k.conv3x3_bias_act(x, kern, b, relu)
    assert k.LAUNCHES["conv3x3_bias_act"] == before + 1
    fp32_math()
    yp = k.conv3x3_bias_act_plain(x, kern, b, relu)
    torch.cuda.synchronize()
    # fp32 sums of up to 9*64 unit-scale terms in another order
    assert float((y - yp).abs().max()) <= 1e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 4, 4, 8), device=cuda)
    kern = torch.zeros((3, 3, 8, 4), device=cuda)
    b = torch.zeros(4, device=cuda)
    before = dict(k.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        k.conv3x3_bias_act(x.transpose(1, 2), kern, b)
    with pytest.raises(ValueError, match="one device"):
        k.conv3x3_bias_act(x, kern, b.cpu())
    with pytest.raises(TypeError):
        k.conv3x3_int8_requant(x, kern.to(torch.int8), b, b)
    assert k.LAUNCHES == before
