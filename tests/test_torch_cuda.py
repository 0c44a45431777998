"""The port's CUDA kernels (tpusr_torch/csrc/conv3x3.cu, nlm.cu, block1.cu)
against their plain twins on the card, at edge shapes the main paths do not
reach: Cin and Cout off the 16-byte vector paths, odd spatial sizes, a single
pixel; for K4 a tiny image, a single row and a size off the 16-pixel tile;
for K3 one image, sizes that need the reflect pad, small patch grids and a
patch that is not a multiple of the 16-pixel tile.

These tests need an NVIDIA card with sm_90a and ``nvcc``; without a card
they skip. ``tests/conftest.py`` imports JAX and hides CUDA devices, so on
the card run them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from tpusr_torch.core import conv3x3 as k
from tpusr_torch.core import nlm
from tpusr_torch.device import fp32_math
from tpusr_torch.models import block1

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


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", K2_SHAPES + [(2, 6, 6, 64, 64)])
def test_k2_bf16_kernel_matches_twin(cuda, shape, relu):
    """K2-bf16 runs K2-f32's fp32 FMAs in K2-f32's order on the bf16 values,
    so it is K2-f32 rounded once, bit for bit; against the twin it is
    within one bf16 ulp beyond the fp32 summation-order gap (chip_smoke.py
    ``check_k2_bf16``)."""
    from chip_smoke import check_k2_bf16
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + relu + 7)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).bfloat16()
    kern = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
            / math.sqrt(9 * cin)).bfloat16()
    b = torch.randn(cout, generator=g, device=cuda) * 0.1
    before = k.LAUNCHES["conv3x3_bias_act_bf16"]
    y = k.conv3x3_bias_act(x, kern, b, relu)
    assert k.LAUNCHES["conv3x3_bias_act_bf16"] == before + 1
    assert y.dtype == torch.bfloat16
    fp32_math()
    yp = k.conv3x3_bias_act_plain(x, kern, b, relu)
    torch.cuda.synchronize()
    check_k2_bf16(x, kern, b, relu, y, yp)      # raises CheckFailed


@pytest.mark.parametrize("hw", [(9, 9), (1, 2048), (513, 511), (16, 33)])
def test_k4_kernel_matches_twin(cuda, hw):
    rng = np.random.default_rng(sum(hw))
    img = np.clip(0.5 + rng.normal(0, 0.1, hw), 0, 1).astype(np.float32)
    x = torch.from_numpy(img).to(cuda)
    sigma = torch.tensor(0.1, device=cuda)
    before = nlm.LAUNCHES["nlm_denoise"]
    y = nlm.nlm_denoise(x, sigma, 1.15 * sigma)
    assert nlm.LAUNCHES["nlm_denoise"] == before + 1
    fp32_math()
    yp = nlm.nl_means_denoise(x, sigma, 1.15 * sigma)
    torch.cuda.synchronize()
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    # exp weights and box sums in another order than the twin's convs
    assert float((y - yp).abs().max()) <= 1e-5


def test_k4_and_k2_bf16_refuse_what_they_do_not_take(cuda):
    before = (dict(k.LAUNCHES), dict(nlm.LAUNCHES))
    img = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        nlm.nlm_denoise(img[None], 0.1, 0.1)
    with pytest.raises(TypeError):
        nlm.nlm_denoise(img.double(), 0.1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        nlm.nlm_denoise(torch.zeros((8, 16), device=cuda)[:, ::2], 0.1, 0.1)
    x = torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.bfloat16)
    kern = torch.zeros((3, 3, 8, 4), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        k.conv3x3_bias_act(x, kern.float(), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        k.conv3x3_bias_act(x, kern, torch.zeros(4, device=cuda).bfloat16())
    with pytest.raises(ValueError):
        k.conv3x3_bias_act(x[0], kern, torch.zeros(4, device=cuda))
    assert (dict(k.LAUNCHES), dict(nlm.LAUNCHES)) == before


@pytest.mark.parametrize("cin", [3, 64])
@pytest.mark.parametrize("hw", [(5, 7), (128, 128), (1, 1)])
def test_int8_dequant_kernel_bit_exact_with_twin(cuda, cin, hw):
    from chip_smoke import _int8_operands
    g = torch.Generator(device=cuda).manual_seed(cin + sum(hw))
    x, wq, rs, b = _int8_operands((2, *hw, cin, 64), g, cuda)
    before = k.LAUNCHES["conv3x3_int8_dequant"]
    y = k.conv3x3_int8_dequant(x, wq, rs, b)
    assert k.LAUNCHES["conv3x3_int8_dequant"] == before + 1
    assert y.dtype == torch.bfloat16
    yp = k.conv3x3_int8_dequant_plain(x, wq, rs, b)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int16), yp.view(torch.int16)), \
        int((y != yp).sum())


# (N, H, W, patch, stride): one image at the serving size, sizes that need
# the reflect pad (bottom and right, one of them repeated), the CPU tests'
# grid, a patch that is not a multiple of the 16-pixel tile, a tiny image
K3_CASES = [(1, 128, 128, 96, 48), (2, 130, 170, 96, 48), (3, 64, 64, 32, 16),
            (2, 37, 45, 32, 16), (1, 50, 70, 40, 24), (2, 9, 9, 16, 8)]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_kernel_bit_exact_with_twin(cuda, case):
    from chip_smoke import block1_operands
    n, h, w, patch, stride = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q, images = block1_operands(g, cuda, n, h, w)
    before = block1.LAUNCHES["block1_int8"]
    y = block1.block1_int8(q, images, patch, stride)
    assert block1.LAUNCHES["block1_int8"] == before + 1
    yp = block1.block1_plain(q, images, patch, stride)
    torch.cuda.synchronize()
    n_h, n_w = block1.grid_counts(h, w, patch, stride)
    assert tuple(y.shape) == (n * n_h * n_w, patch // 2, patch // 2, 64)
    assert torch.equal(y, yp), int((y != yp).sum())
    assert int(torch.unique(y).numel()) > 16         # not collapsed


def test_k3_takes_an_unaligned_sub_batch_view(cuda):
    """A classify_chunks split of an odd-sized batch starts off a 16-byte
    boundary (3 * 37 * 45 bytes per image)."""
    from chip_smoke import block1_operands
    g = torch.Generator(device=cuda).manual_seed(3)
    q, images = block1_operands(g, cuda, 3, 37, 45)
    view = images[1:]
    assert view.data_ptr() % 16 and view.is_contiguous()
    y = block1.block1_int8(q, view, 32, 16)
    torch.cuda.synchronize()
    assert torch.equal(y, block1.block1_plain(q, view, 32, 16))


def test_k3_refuses_what_it_does_not_take(cuda):
    from chip_smoke import block1_operands
    g = torch.Generator(device=cuda).manual_seed(0)
    q, images = block1_operands(g, cuda, 1, 32, 32)
    before = dict(block1.LAUNCHES)
    with pytest.raises(TypeError):
        block1.block1_int8(q, images.float(), 32, 16)
    with pytest.raises(ValueError, match="even"):
        block1.block1_int8(q, images, 31, 16)
    with pytest.raises(ValueError, match="contiguous"):
        block1.block1_int8(q, images.transpose(1, 2), 32, 16)
    with pytest.raises(ValueError, match="one device"):
        block1.block1_int8(q, images.cpu(), 32, 16)
    assert block1.LAUNCHES == before
