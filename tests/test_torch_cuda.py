"""The port's CUDA kernels (tpusr_torch/csrc/conv3x3.cu, conv3x3_bias_act.cu,
nlm.cu, block1.cu) against their plain twins on the card, at edge shapes the
main paths do not reach: Cin and Cout off the 16-byte vector paths, odd
spatial sizes, a single pixel; for K1 and the dequant conv (int8 tensor
cores) M off the 128-pixel tile, Cout 3 to 512, Cin 3 to 512, tiles that
cross images and the largest |acc| of a 512-channel conv; for K2 the
serving shapes' edges (Cout = 256 on several N tiles, the 3-channel tail,
the Cin = 3 head) and batch invariance; for K4 a tiny image, a single row
and a size off the 16-pixel tile;
for K3 (int8 tensor cores) one image, sizes that need the reflect pad,
small patch grids, patches that are not a multiple of the 16 x 32 tile,
|acc| at its 576 * 127^2 maximum, batch invariance, fewer work items than
resident blocks and a tree without packed weights; the per-patch int8
classifier at an odd patch, which runs on K1 alone; a two-image run of
the serving gate with its launch counts; K2 at ESRGAN's shapes (the dense
blocks' Cin 64 + i * growth, Cout = growth, Cin 72 and 88 off the narrow
kernel), a narrow ESRGAN generator and patch SR on K2 against the twin; the
HTTP tier answering each kind of request on the card; the bf16 K2 training
Function against its twin, one G step of the GAN trainer on K2 against the
twin, and the profiling helpers on the card.

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
             (2, 6, 6, 200, 12), (1, 1, 1, 128, 6), (4, 3, 11, 4, 130),
             # M off the 128-pixel tile with Cin and Cout 512 (4 N tiles)
             (3, 7, 9, 512, 512),
             # 6x6 images: every 128-pixel tile crosses images
             (9, 6, 6, 64, 128),
             # the gather loader on 128-wide tiles; 200 and 16 on one N tile
             (2, 13, 11, 3, 512), (2, 10, 10, 200, 64), (1, 5, 5, 16, 64),
             # serving-like: trunk block 5 at 35^2, patch block 5 at 6^2
             (2, 35, 35, 512, 512), (40, 6, 6, 512, 512)]
K2_SHAPES = [(3, 5, 7, 16, 8), (2, 9, 9, 64, 3), (1, 7, 5, 3, 64),
             (2, 6, 6, 20, 12), (1, 1, 1, 64, 6), (2, 4, 13, 32, 130),
             # serving-like: an up0 slab, a tail slab, the head
             (2, 7, 128, 64, 256), (2, 28, 40, 64, 3), (2, 16, 16, 3, 64)]


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
    y_packed = k.conv3x3_int8_requant(x, wq, rs, b, k.pack_int8_kernel(wq))
    assert k.LAUNCHES["conv3x3_int8_requant"] == before + 2
    yp = k.conv3x3_int8_requant_plain(x, wq, rs, b)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), int((y != yp).sum())
    assert torch.equal(y_packed, y)
    assert int(torch.unique(y).numel()) > min(16, y.numel() // 8)


def _largest_acc_operands(cuda, shape):
    """x = 127 and w = -127 everywhere: |acc| = 9*Cin*127^2 (74.3M at Cin =
    512) inside the image, fewer taps on its border; negative rescales
    spread the requant over [0, 127]."""
    n, h, w, cin, cout = shape
    x = torch.full((n, h, w, cin), 127, dtype=torch.int8, device=cuda)
    wq = torch.full((3, 3, cin, cout), -127, dtype=torch.int8, device=cuda)
    rs = -(torch.arange(cout, device=cuda, dtype=torch.float32) + 1.0) \
        * (127.0 / cout / (9 * cin * 127.0 ** 2))
    b = torch.full((cout,), 0.5, device=cuda)
    return x, wq, rs, b


@pytest.mark.parametrize("shape", [(2, 6, 7, 512, 512), (1, 9, 9, 512, 64)])
def test_k1_and_dequant_at_the_largest_accumulator(cuda, shape):
    x, wq, rs, b = _largest_acc_operands(cuda, shape)
    y = k.conv3x3_int8_requant(x, wq, rs, b)
    d = k.conv3x3_int8_dequant(x, wq, rs, b)
    yp = k.conv3x3_int8_requant_plain(x, wq, rs, b)
    dp = k.conv3x3_int8_dequant_plain(x, wq, rs, b)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), int((y != yp).sum())
    assert torch.equal(d.view(torch.int16), dp.view(torch.int16))
    assert int(y.max()) == 127 and float(d.max()) > 126.0


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
    """K2-bf16 sums the exact bf16 products on the tensor cores in their own
    fp32 order, so against the twin (fp32 F.conv2d on the same values) it
    is held to the derived bound of chip_smoke.py ``k2_bf16_tolerance``:
    one bf16 ulp plus the worst case of two fp32 sums of 9*Cin terms."""
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
    check_k2_bf16(x, kern, y, yp)      # raises CheckFailed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 24, 20, 64, 64), (16, 14, 40, 64, 3),
                                   (16, 9, 11, 3, 64)])
def test_k2_is_batch_invariant(cuda, shape, dtype):
    """Each output's sum runs in one order whatever the batch: images 0-1 of
    a 16-image launch equal a 2-image launch bit for bit (the server pads
    partial batches)."""
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
    kern = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
            / math.sqrt(9 * cin)).to(dtype)
    b = torch.randn(cout, generator=g, device=cuda) * 0.1
    y16 = k.conv3x3_bias_act(x, kern, b, True)
    y2 = k.conv3x3_bias_act(x[:2].contiguous(), kern, b, True)
    torch.cuda.synchronize()
    assert torch.equal(y16[:2], y2)


@pytest.mark.parametrize("hw", [(9, 9), (1, 2048), (513, 511), (16, 33),
                                (128, 128), (2048, 2048), (29, 61),
                                (127, 129)])
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


def _k4_image(cuda, hw, seed):
    rng = np.random.default_rng(seed)
    img = np.clip(0.5 + rng.normal(0, 0.1, hw), 0, 1).astype(np.float32)
    return torch.from_numpy(img).to(cuda)


@pytest.mark.parametrize("hw", [(128, 128), (61, 29)])
def test_k4_every_config_matches_twin(cuda, hw):
    """Each (rows, split) instantiation of nlm.cu, launched directly, not
    only the one the wrapper picks at this size."""
    x = _k4_image(cuda, hw, 21)
    sigma = torch.tensor(0.1, device=cuda)
    h = 1.15 * sigma
    fp32_math()
    yp = nlm.nl_means_denoise(x, sigma, h)
    for rows, split in nlm.CONFIGS:
        y = torch.full_like(x, float("nan"))
        nlm.launch(x, sigma, h, y, rows, split)
        torch.cuda.synchronize()
        assert float((y - yp).abs().max()) <= 1e-5, (rows, split)


def test_k4_is_bit_for_bit_repeatable(cuda):
    x = _k4_image(cuda, (128, 128), 22)
    sigma = torch.tensor(0.1, device=cuda)
    runs = [nlm.nlm_denoise(x, sigma, 1.15 * sigma) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_k4_keeps_a_constant_image(cuda):
    x = torch.full((128, 96), 0.375, device=cuda)
    y = nlm.nlm_denoise(x, 0.05, 0.06)
    torch.cuda.synchronize()
    assert float((y - x).abs().max()) <= 1e-6


@pytest.mark.parametrize("sigma,h", [(0.0, 0.1), (0.0, 0.0), (10.0, 0.1)])
def test_k4_at_sigma_zero_and_large(cuda, sigma, h):
    """sigma 0 keeps d2 whole, h 0 meets the 1e-12 floor (only equal
    patches keep weight), a large sigma gives every offset weight 1: the
    mean of the 169 shifted values."""
    x = _k4_image(cuda, (40, 56), 23)
    y = nlm.nlm_denoise(x, sigma, h)
    fp32_math()
    yp = nlm.nl_means_denoise(x, sigma, h)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert float((y - yp).abs().max()) <= 1e-5
    if sigma == 10.0:
        from tpusr_torch.core.pad import pad_2d
        xp = pad_2d(x, 6)
        mean = sum(xp[dy:dy + 40, dx:dx + 56] for dy in range(13)
                   for dx in range(13)) / 169.0
        assert float((y - mean).abs().max()) <= 1e-5


def test_k4_with_device_scalars_is_one_launch_and_nothing_else(cuda):
    """0-d float32 sigma and h on the card: the call dispatches no PyTorch
    op but the output's allocation, and launches the kernel once."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x = _k4_image(cuda, (64, 64), 24)
    sigma = torch.tensor(0.1, device=cuda)
    h = torch.tensor(0.115, device=cuda)
    nlm.nlm_denoise(x, sigma, h)                      # build and load first
    before = nlm.LAUNCHES["nlm_denoise"]
    with Ops() as ops:
        y = nlm.nlm_denoise(x, sigma, h)
    assert ops.seen == ["aten.empty_like.default"]
    assert nlm.LAUNCHES["nlm_denoise"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(y, nlm.nlm_denoise(x, 0.1, 0.115))


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


@pytest.mark.parametrize("cin", [3, 16, 64, 200, 512])
@pytest.mark.parametrize("hw", [(5, 7), (128, 128), (1, 1)])
def test_int8_dequant_kernel_bit_exact_with_twin(cuda, cin, hw):
    _check_dequant(cuda, (2, *hw, cin, 64))


# Cout 3, 130 and 512 (several N tiles), 6x6 images across tiles
DEQUANT_SHAPES = [(2, 9, 9, 64, 3), (4, 3, 11, 16, 130), (3, 7, 9, 512, 512),
                  (9, 6, 6, 64, 64), (2, 13, 11, 3, 512)]


@pytest.mark.parametrize("shape", DEQUANT_SHAPES)
def test_int8_dequant_kernel_cout_and_tiles(cuda, shape):
    _check_dequant(cuda, shape)


def _check_dequant(cuda, shape):
    from chip_smoke import _int8_operands
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, wq, rs, b = _int8_operands(shape, g, cuda)
    before = k.LAUNCHES["conv3x3_int8_dequant"]
    y = k.conv3x3_int8_dequant(x, wq, rs, b, k.pack_int8_kernel(wq))
    assert k.LAUNCHES["conv3x3_int8_dequant"] == before + 1
    assert y.dtype == torch.bfloat16
    yp = k.conv3x3_int8_dequant_plain(x, wq, rs, b)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int16), yp.view(torch.int16)), \
        int((y != yp).sum())


# (N, H, W, patch, stride): one image at the serving size, sizes that need
# the reflect pad (bottom and right, one of them repeated), the CPU tests'
# grid, patches that are not a multiple of the 16 x 32 tile (40 in neither
# direction, 48 across only) or narrower than it, a tiny image
K3_CASES = [(1, 128, 128, 96, 48), (2, 130, 170, 96, 48), (3, 64, 64, 32, 16),
            (2, 37, 45, 32, 16), (1, 50, 70, 40, 24), (2, 9, 9, 16, 8),
            (1, 70, 90, 48, 32)]


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


@pytest.mark.parametrize("sign", [1, -1])
def test_k3_at_the_largest_accumulator(cuda, sign):
    """Images 127 and b1c1 weights 127 saturate b1c1 at 127 inside each
    patch; b1c2 weights of +-127 then give |acc| = 576 * 127^2 (9.29M) in the
    patch interior, fewer taps on its border; rescales of b1c2's sign spread
    the requant over [0, 127]."""
    from chip_smoke import block1_operands
    g = torch.Generator(device=cuda).manual_seed(11)
    q, _ = block1_operands(g, cuda, 1, 1, 1, packed=False)
    l1, l2 = q["layers"]["block1_conv1"], q["layers"]["block1_conv2"]
    l1["kernel_q"].fill_(127)
    l1["rescale"].fill_(1.0)
    l2["kernel_q"].fill_(127 * sign)
    l2["rescale"] = sign * (torch.arange(64, device=cuda, dtype=torch.float32)
                            + 1.0) * (127.0 / 64 / (576 * 127.0 ** 2))
    l2["bias_over_out"].fill_(0.5)
    images = torch.full((2, 130, 100, 3), 127, dtype=torch.int8, device=cuda)
    y = block1.block1_int8(q, images, 96, 48)
    yp = block1.block1_plain(q, images, 96, 48)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), int((y != yp).sum())
    assert int(y.max()) == 127 and int(torch.unique(y).numel()) > 32


def test_k3_is_batch_invariant(cuda):
    """The patches of images 0-1 of a 16-image launch equal a 2-image
    launch bit for bit (int32 sums, no split-K, the grid set by the card)."""
    from chip_smoke import block1_operands
    g = torch.Generator(device=cuda).manual_seed(12)
    q, images = block1_operands(g, cuda, 16, 128, 128)
    y16 = block1.block1_int8(q, images, 96, 48)
    y2 = block1.block1_int8(q, images[:2].contiguous(), 96, 48)
    torch.cuda.synchronize()
    per_image = y16.shape[0] // 16
    assert torch.equal(y16[:2 * per_image], y2)


def test_k3_with_fewer_items_than_resident_blocks(cuda):
    """One 16^2 image at patch 16: one patch, one work item for a grid
    sized to the card."""
    from chip_smoke import block1_operands
    g = torch.Generator(device=cuda).manual_seed(13)
    q, images = block1_operands(g, cuda, 1, 16, 16)
    y = block1.block1_int8(q, images, 16, 16)
    yp = block1.block1_plain(q, images, 16, 16)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (1, 8, 8, 64)
    assert torch.equal(y, yp), int((y != yp).sum())


def test_k3_packs_a_tree_without_kernel_packed(cuda):
    from chip_smoke import block1_operands
    g = torch.Generator(device=cuda).manual_seed(14)
    q, images = block1_operands(g, cuda, 2, 64, 80)
    bare = {"layers": {n: {k: v for k, v in layer.items() if k != "kernel_packed"}
                       for n, layer in q["layers"].items()}}
    y = block1.block1_int8(q, images, 32, 16)
    y_bare = block1.block1_int8(bare, images, 32, 16)
    torch.cuda.synchronize()
    assert torch.equal(y, y_bare)
    assert torch.equal(y, block1.block1_plain(q, images, 32, 16))


def test_per_patch_int8_at_an_odd_patch_runs_k1_alone(cuda):
    """Patch 33 (K3 takes even patches only): 13 K1 launches per call and no
    K3 launch; the probabilities equal the same call on the plain twins."""
    from chip_smoke import on_plain_twins
    from tpusr_torch.models import VGG16Classifier
    from tpusr_torch.models import quant
    vgg = VGG16Classifier(num_classes=2, dense_units=16,
                          widths=(64, 16, 16, 32, 32), device=cuda,
                          generator=torch.Generator().manual_seed(15))
    g = torch.Generator(device=cuda).manual_seed(15)
    calib = torch.rand((8, 33, 33, 3), generator=g, device=cuda)
    q = quant.quantize_vgg16(vgg, quant.calibrate_vgg16(vgg, calib))
    images = torch.rand((2, 64, 64, 3), generator=g, device=cuda)
    before = (k.LAUNCHES["conv3x3_int8_requant"], block1.LAUNCHES["block1_int8"])
    probs = quant.per_patch_int8_probs(q, images, 33, 16)
    after = (k.LAUNCHES["conv3x3_int8_requant"], block1.LAUNCHES["block1_int8"])
    assert (after[0] - before[0], after[1] - before[1]) == (13, 0)
    with on_plain_twins():
        plain = quant.per_patch_int8_probs(q, images, 33, 16)
    torch.cuda.synchronize()
    n_h, n_w = block1.grid_counts(64, 64, 33, 16)
    assert tuple(probs.shape) == (2, n_h * n_w, 2)
    assert torch.equal(probs, plain)


# the training path: K2 under autograd (Conv3x3BiasActFn) at the EDSR x4
# training shapes of the serving gate (batch 16, LR 32^2), forward shapes
TRAIN_LAYERS = [("head", (16, 32, 32, 3, 64), False),
                ("res.conv1", (16, 32, 32, 64, 64), True),
                ("res.conv2", (16, 32, 32, 64, 64), False),
                ("up0", (16, 32, 32, 64, 256), False),
                ("up1", (16, 64, 64, 64, 256), False),
                ("tail", (16, 128, 128, 64, 3), False)]


@pytest.mark.parametrize("layer", TRAIN_LAYERS, ids=[n for n, *_ in TRAIN_LAYERS])
def test_k2_function_matches_autograd_through_the_twin(cuda, layer):
    """dX (K2 on the flipped, transposed kernel: Cin 256 at up0/up1, Cin 3 at
    the tail) within chip_smoke.k2_f32_bound of autograd through the twin on
    the same (ReLU-masked) dY; dW and db within 1e-5 of their max; two K2
    launches, one for the head (its input needs no gradient)."""
    from chip_smoke import k2_f32_bound
    name, (n, h, w, cin, cout), relu = layer
    g = torch.Generator(device=cuda).manual_seed(cin + cout + h)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda)
    kern = torch.randn((3, 3, cin, cout), generator=g, device=cuda) \
        * math.sqrt(2.0 / (9 * cin))
    b = torch.randn(cout, generator=g, device=cuda) * 0.1
    dy = torch.randn((n, h, w, cout), generator=g, device=cuda)
    need_dx = name != "head"
    xa = x.clone().requires_grad_(need_dx)
    ka, ba = kern.clone().requires_grad_(), b.clone().requires_grad_()
    before = k.LAUNCHES["conv3x3_bias_act"]
    y = k.conv3x3_bias_act_train(xa, ka, ba, relu)
    y.backward(dy)
    assert k.LAUNCHES["conv3x3_bias_act"] == before + 1 + need_dx
    fp32_math()
    xb = x.clone().requires_grad_(need_dx)
    kb, bb = kern.clone().requires_grad_(), b.clone().requires_grad_()
    pre = k.conv3x3_bias_act_plain(xb, kb, bb, False)
    g_ref = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    pre.backward(g_ref)
    torch.cuda.synchronize()
    if relu:   # masks differ only where the twin's pre-activation is ~0
        flips = (y > 0) != (pre > 0)
        assert not bool(flips.any()) or float(pre[flips].abs().max()) <= 1e-4
    if need_dx:
        k_t = kern.flip(0, 1).transpose(2, 3).contiguous()
        d = (xa.grad.double() - xb.grad.double()).abs()
        assert bool((d <= k2_f32_bound(g_ref, k_t)).all()), float(d.max())
    else:
        assert xa.grad is None
    for got, want in ((ka.grad, kb.grad), (ba.grad, bb.grad)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(16, 32, 32, 256, 64), (16, 64, 64, 256, 64),
                                   (2, 7, 9, 256, 64), (3, 6, 10, 256, 130),
                                   (1, 5, 5, 256, 3)])
def test_k2_at_cin_256_matches_twin(cuda, shape):
    """K = 2304 through K2-f32's loader and shared-memory ring (the dX convs
    of up0 and up1; no serving path launches Cin 256)."""
    from chip_smoke import k2_f32_bound
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn((n, h, w, cin), generator=g, device=cuda)
    kern = torch.randn((3, 3, cin, cout), generator=g, device=cuda) \
        / math.sqrt(9 * cin)
    b = torch.randn(cout, generator=g, device=cuda) * 0.1
    y = k.conv3x3_bias_act(x, kern, b)
    fp32_math()
    yp = k.conv3x3_bias_act_plain(x, kern, b)
    torch.cuda.synchronize()
    d = (y.double() - yp.double()).abs()
    assert bool((d <= k2_f32_bound(x, kern)).all()), float(d.max())


def test_edsr_train_step_on_k2_matches_the_twin(cuda):
    """A narrow EDSR x4 under SupervisedSRTrainer on K2 against the same
    trainer through the twin: the first step's gradients within 1e-5 of
    each leaf's max|g| (as the CPU tests hold them against jax.grad; a
    wrong dX shows in every leaf before the last conv), 17 K2 launches (9
    forward, 8 dX) and no call of the twin; then three steps, whose second
    and third losses follow an update, within rtol 1e-4."""
    from chip_smoke import count_plain_calls, train_on_plain_twin
    from tpusr_torch.models import EDSR
    from tpusr_torch.train import SupervisedSRTrainer
    model = EDSR(4, num_res_blocks=2, num_filters=16, device=cuda,
                 generator=torch.Generator().manual_seed(3))
    tr = SupervisedSRTrainer(model, learning_rate=1e-4, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    xs = torch.rand((3, 4, 16, 16, 3), generator=g, device=cuda)
    ys = torch.rand((3, 4, 64, 64, 3), generator=g, device=cuda)
    before = k.LAUNCHES["conv3x3_bias_act"]
    with count_plain_calls() as plain:
        _, _, g_k2 = tr.value_and_grad(tr.init_state(), xs[0], ys[0])
        torch.cuda.synchronize()
    assert k.LAUNCHES["conv3x3_bias_act"] - before == 17 and plain.n == 0
    with train_on_plain_twin():
        _, _, g_tw = tr.value_and_grad(tr.init_state(), xs[0], ys[0])
    assert list(g_k2) == list(g_tw)
    for name, want in g_tw.items():
        err = float((g_k2[name] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (name, err)

    def losses(state):
        out = []
        for x, y in zip(xs, ys):
            state, m = tr.train_step(state, x, y)
            out.append(float(m["loss"]))
        return out
    on_k2 = losses(tr.init_state())
    with train_on_plain_twin():
        on_twin = losses(tr.init_state())
    for a, b in zip(on_k2, on_twin):
        assert abs(a - b) <= 1e-4 * abs(b), (on_k2, on_twin)

def test_gate_runs_two_images_on_the_card(cuda):
    """tests/test_serving_gate.py::test_gate_harness_end_to_end_smoke on the
    card: two 128^2 eval images, two training steps of each full-size
    network, two modes (the f32-SR trunk and the no-border int8-SR trunk).
    It launches K2 (146 training, 46 f32 SR, 34 calibrating the int8 SR),
    the dequant conv (34) and K1 (13 per trunk), builds only the int8 SR
    variant a mode consumes, and calls no plain twin on the card."""
    from chip_smoke import count_plain_calls
    from tpusr_torch.tools import serving_gate as sg
    modes = ("shared_trunk_int8", "int8_sr_noborder_shared_trunk_int8")
    k.reset_launch_counts()
    block1.reset_launch_counts()
    with count_plain_calls() as plain:
        rep = sg.run_gate(n_images=2, size=128, clf_steps=2, edsr_steps=2,
                          verbose=False, mode_names=modes, device=cuda)
        torch.cuda.synchronize()
    assert plain.n == 0, plain.by_twin
    assert k.LAUNCHES == {"conv3x3_bias_act": 2 * 73 + 46 + 34,
                          "conv3x3_bias_act_bf16": 0,
                          "conv3x3_int8_dequant": 34,
                          "conv3x3_int8_requant": 2 * 13}
    assert block1.LAUNCHES["block1_int8"] == 0
    assert {m["mode"] for m in rep["modes"]} == set(modes)
    assert rep["psnr_int8_noborder_sr_vs_f32_sr_db"] is not None
    assert rep["psnr_int8_sr_vs_f32_sr_db"] is None
    nb = next(m for m in rep["modes"]
              if m["mode"] == "int8_sr_noborder_shared_trunk_int8")
    assert "sr_psnr_vs_f32_db" in nb and "image_faithful" in nb
    assert len(rep["raw_votes"]["reference"]["cls"]) == 2


# ESRGAN's 3x3 convs on K2: the dense blocks' concatenated inputs (Cin 64 +
# i * growth, Cout = growth, then back to 64; Cin 72 and 88 are off the
# 16-channel narrow kernel and take the GEMM), the upsample conv (64 -> 256)
# and the final convs at 2x
ESRGAN_K2_SHAPES = [(1, 128, 128, 64, 8), (1, 128, 128, 72, 8),
                    (1, 128, 128, 80, 8), (1, 128, 128, 88, 8),
                    (1, 128, 128, 96, 64), (1, 128, 128, 64, 256),
                    (1, 128, 128, 192, 64), (1, 128, 128, 160, 32),
                    (25, 48, 48, 72, 8), (1, 256, 256, 64, 3)]


@pytest.mark.parametrize("shape", ESRGAN_K2_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_k2_at_the_esrgan_shapes_matches_twin(cuda, shape, relu):
    """Within chip_smoke.k2_forward_bound of the twin, per output."""
    from chip_smoke import k2_forward_bound
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
    d = (y.double() - yp.double()).abs()
    assert bool((d <= k2_forward_bound(x, kern, b)).all()), float(d.max())


def _narrow_esrgan(cuda, scale):
    from tpusr_torch.models.esrgan import ESRGANGenerator
    gen = ESRGANGenerator(scale_factor=scale, growth_channels=8,
                          num_rrdb_blocks=2, base_filters=32, device=cuda,
                          generator=torch.Generator().manual_seed(scale))
    with torch.no_grad():     # non-zero biases, so their paths are held too
        for name, p in gen.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator(
                    device=cuda).manual_seed(len(name)))
    return gen


@pytest.mark.parametrize("scale", [2, 4])
def test_narrow_esrgan_generator_on_k2_matches_the_twin(cuda, scale):
    """Every 3x3 conv of the generator on K2 (1 + 15 * 2 + 1 + log2(s) + 2
    launches), within 1/2 x launches x K2_ATOL of the same forward on the
    twin after the [0, 1] map, as chip_smoke holds the full-width paths;
    no plain twin on the card."""
    from chip_smoke import (K2_ATOL, count_plain_calls, esrgan_launches,
                            models_on_k2_twin)
    gen = _narrow_esrgan(cuda, scale)
    x = torch.rand((2, 24, 24, 3), generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda) * 2 - 1
    before = k.LAUNCHES["conv3x3_bias_act"]
    with count_plain_calls() as plain, torch.inference_mode():
        y = gen(x)
    launches = esrgan_launches(2, scale)
    assert k.LAUNCHES["conv3x3_bias_act"] - before == launches
    assert plain.n == 0, plain.by_twin
    with models_on_k2_twin(), torch.inference_mode():
        yp = gen(x)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (2, 24 * scale, 24 * scale, 3)
    err = float((y - yp).abs().max()) / 2
    assert err <= 0.5 * launches * K2_ATOL, err


def test_super_resolve_image_on_k2_matches_the_twin(cuda):
    """Patch SR with a narrow EDSR x4 (1 block, 16 filters): 7 K2 launches
    on the 9 patches of a 40^2 LR image at patch 16, stride 12, within
    chip_smoke.SR_ATOL of the same call on the twin; the reference's
    metrics fields, from the card's allocator."""
    from chip_smoke import SR_ATOL, count_plain_calls, models_on_k2_twin
    from tpusr_torch.models import EDSR
    from tpusr_torch.pipeline.inference import super_resolve_image
    edsr = EDSR(4, num_res_blocks=1, num_filters=16, device=cuda,
                generator=torch.Generator().manual_seed(4))
    lr = np.random.default_rng(4).random((40, 40, 3), dtype=np.float32)
    before = k.LAUNCHES["conv3x3_bias_act"]
    with count_plain_calls() as plain:
        sr, metrics = super_resolve_image(edsr, lr, patch_size_lr=16,
                                          stride=12, scale=4)
    assert k.LAUNCHES["conv3x3_bias_act"] - before == 7 and plain.n == 0
    with models_on_k2_twin():
        ref, _ = super_resolve_image(edsr, lr, patch_size_lr=16, stride=12,
                                     scale=4)
    assert sr.is_cuda and tuple(sr.shape) == (160, 160, 3)
    assert float((sr - ref).abs().max()) <= SR_ATOL
    assert metrics["gpu_peak_mb"] > 0 and metrics["time_sec"] > 0


def test_http_tier_on_the_card_answers_each_kind(cuda):
    """make_http_server over a narrow per_patch_int8 pipeline on the card:
    /healthz, /classify, /sr (equal byte for byte to the pipeline's SR of the
    served batch) and /classify_sr answer, a truncated JPEG body gets 400; K2, K1 and
    K3 launch and no plain twin runs."""
    import json
    import threading
    import urllib.request

    from chip_smoke import count_plain_calls
    from tpusr_torch.models import EDSR, VGG16Classifier
    from tpusr_torch.pipeline import PipelineServer, make_serving_pipeline
    from tpusr_torch.pipeline.http_serving import make_http_server
    from tpusr_torch.pipeline.png import encode_png

    lr_side, patch = 32, 32
    gen = torch.Generator().manual_seed(9)
    edsr = EDSR(2, num_res_blocks=1, num_filters=16, device=cuda, generator=gen)
    vgg = VGG16Classifier(num_classes=2, dense_units=16,
                          widths=(64, 16, 16, 32, 32), device=cuda,
                          generator=gen)
    calib = torch.rand((8, patch, patch, 3), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(9))
    pipe = make_serving_pipeline(edsr, vgg, (lr_side, lr_side), 2,
                                 patch=patch, stride=16, sr_mode="f32",
                                 clf_mode="per_patch_int8",
                                 calib_patches=calib, device=cuda)
    img = np.random.default_rng(9).random((lr_side, lr_side, 3),
                                          dtype=np.float32)
    body = encode_png(img)
    with PipelineServer(pipe, batch_size=2, max_wait_ms=1) as server:
        httpd = make_http_server(server, (lr_side, lr_side), port=0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def call(path, data=None):
            req = urllib.request.Request(base + path, data=data)
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()
        try:
            k.reset_launch_counts()
            block1.reset_launch_counts()
            with count_plain_calls() as plain:
                assert call("/healthz")[0] == 200
                status, data = call("/classify", body)
                assert status == 200 and json.loads(data)["class"] in (0, 1)
                status, sr_png = call("/sr", body)
                assert status == 200
                status, data = call("/classify_sr", body)
                assert status == 200 and "sr_png_base64" in json.loads(data)
                status, _ = call("/classify", b"\xff\xd8\xff\xe0" + bytes(32))
                assert status == 400
            assert plain.n == 0, plain.by_twin
            assert k.LAUNCHES["conv3x3_bias_act"] > 0
            assert k.LAUNCHES["conv3x3_int8_requant"] > 0
            assert block1.LAUNCHES["block1_int8"] > 0
            x = torch.as_tensor(np.clip(img * 255 + 0.5, 0, 255).astype(
                np.uint8).astype(np.float32) / 255.0, device=cuda)
            with torch.inference_mode():
                sr = pipe.sr_apply(x[None].repeat(2, 1, 1, 1))[0]
            assert encode_png(sr.cpu().numpy()) == sr_png
        finally:
            httpd.shutdown()
            httpd.server_close()


@pytest.mark.parametrize("shape,relu", [((2, 12, 12, 72, 8), True),
                                        ((2, 24, 24, 64, 256), False),
                                        ((3, 9, 7, 3, 64), False),
                                        ((2, 48, 48, 64, 3), False)])
def test_k2_bf16_training_function_matches_the_twin(cuda, shape, relu):
    """The bf16 K2 Function (K2-bf16 forward and dX) on the card: the
    forward and dX each within ``chip_smoke.k2_bf16_tolerance`` of the twin
    on the same bf16 inputs (the dense block's Cin = 72 on the general
    kernel, the 64 -> 256 upsample conv, the Cin = 3 head, the 3-channel
    tail), dW within 1 bf16 ulp plus the fp32 sum's bound of cuDNN's bf16
    ``conv2d_weight`` (the same call), db in fp32, the gradients in their
    inputs' dtypes, two K2-bf16 launches."""
    from chip_smoke import check_k2_bf16
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).bfloat16()
    kk = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
          * math.sqrt(2.0 / (9 * cin))).bfloat16()
    b = torch.randn(cout, generator=g, device=cuda) * 0.1
    dy = torch.randn((n, h, w, cout), generator=g, device=cuda).bfloat16()
    xt, kt, bt = (t.clone().requires_grad_() for t in (x, kk, b))
    before = k.LAUNCHES["conv3x3_bias_act_bf16"]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # dW twice, the same sums
    try:
        y = k.conv3x3_bias_act_train(xt, kt, bt, relu)
        y.backward(dy)
        gm = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
        dw = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (cout, cin, 3, 3), gm.permute(0, 3, 1, 2),
            padding=1).permute(2, 3, 1, 0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    assert k.LAUNCHES["conv3x3_bias_act_bf16"] - before == 2
    assert (y.dtype, xt.grad.dtype, kt.grad.dtype, bt.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)
    check_k2_bf16(x, kk, y.detach(), conv3x3_bias_act_plain(x, kk, b, relu))
    k_t = kk.flip(0, 1).transpose(2, 3).contiguous()
    zero = torch.zeros(cin, device=cuda)
    check_k2_bf16(gm, k_t, xt.grad, conv3x3_bias_act_plain(gm, k_t, zero))
    assert torch.equal(kt.grad, dw)
    db = gm.float().sum((0, 1, 2))
    assert torch.allclose(bt.grad, db, rtol=1e-5, atol=1e-5)


def test_gan_step_on_k2_matches_the_twin(cuda):
    """One G step of a narrow ESRGAN (growth 8, 1 RRDB, x2, LR 16^2) under
    ``ESRGANTrainer`` with VGG19 and D on cuDNN: the G gradient on K2 (20
    forward and 19 dX launches, no twin), each conv held on its recorded
    input and output gradient against autograd through the twin
    (``chip_smoke.k2_backward_case``: dX within ``k2_f32_bound``, dW and db
    within 1e-5 of their max, ReLU masks apart only near 0); then two full
    steps' losses within rtol 1e-4."""
    from chip_smoke import (count_plain_calls, k2_backward_case,
                            k2_train_io, new_worst, train_on_plain_twin)
    from tpusr_torch.models import (ESRGANDiscriminator, ESRGANGenerator,
                                    VGG19Features)
    from tpusr_torch.train import ESRGANTrainer
    gen = ESRGANGenerator(2, 8, 1, device=cuda,
                          generator=torch.Generator().manual_seed(1))
    tr = ESRGANTrainer(gen, ESRGANDiscriminator(device=cuda),
                       VGG19Features(device=cuda), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    lr = torch.rand((2, 4, 16, 16, 3), generator=g, device=cuda) * 2 - 1
    hr = torch.rand((2, 4, 32, 32, 3), generator=g, device=cuda) * 2 - 1

    def grads(state):
        with torch.enable_grad():
            total, _ = tr.g_loss_components(state.g_params, state.d_params,
                                            state.d_spectral, lr[0], hr[0])
            out = torch.autograd.grad(total, list(state.g_params.values()))
        return dict(zip(state.g_params, out))
    before = k.LAUNCHES["conv3x3_bias_act"]
    st = tr.init_state()
    with count_plain_calls() as plain, k2_train_io() as rec:
        grads(st)
        torch.cuda.synchronize()
    assert k.LAUNCHES["conv3x3_bias_act"] - before == 39 and plain.n == 0
    worst = new_worst()
    for i, (x, kern, bias, relu, dy) in enumerate(rec.calls):
        k2_backward_case(f"conv {i}", x, dy, kern, bias, relu, i > 0, worst)
    assert len(rec.calls) == 20

    def losses(state):
        out = []
        for i in range(2):
            state, m = tr.train_step(state, lr[i], hr[i])
            out.append((float(m["g_loss"]), float(m["d_loss"])))
        return out
    on_k2 = losses(tr.init_state())
    with train_on_plain_twin():
        on_twin = losses(tr.init_state())
    for a, b in zip(on_k2, on_twin):
        for u, v in zip(a, b):
            assert abs(u - v) <= 1e-4 * abs(v), (on_k2, on_twin)


def test_profiling_helpers_on_the_card(cuda, tmp_path):
    """``trace`` records the card's kernels (K2's among them),
    ``time_compiled`` waits for the card (a sleep kernel of 4e6 cycles,
    2 ms at the 1.98 GHz boost clock, makes a call last at least 1 ms),
    ``device_memory_mb`` reads the allocator."""
    import json
    from tpusr_torch.train import profiling
    x = torch.randn((1, 8, 8, 16), device=cuda)
    kk = torch.randn((3, 3, 16, 8), device=cuda)
    b = torch.zeros(8, device=cuda)
    with profiling.trace(str(tmp_path)):
        k.conv3x3_bias_act(x, kk, b)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" and "conv3x3" in e.get("name", "")
               for e in events)
    t = profiling.time_compiled(lambda: (torch.cuda._sleep(4_000_000), x)[1],
                                iters=3)
    assert t >= 1e-3
    held = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    mem = profiling.device_memory_mb(cuda)
    assert mem["current_mb"] >= 64 and mem["peak_mb"] >= mem["current_mb"]
    del held



TRACE_SESSIONS = 24      # profiling.trace sessions, one after another
TRACE_LAUNCHES = 200     # K2 launches in each session's block


def test_trace_keeps_every_kernel_record_across_sessions(cuda, tmp_path):
    """torch.profiler on the card has lost the kernel records of the first
    launches of a session (their launch records stay) late in a long
    process. In each of ``TRACE_SESSIONS`` ``profiling.trace`` sessions of
    one process, every K2 launch of the block has its kernel record, and
    the lead is at least twice the records it lost
    (``chip_smoke.trace_records``). Run with ``-s`` to print the losses."""
    import json
    from chip_smoke import trace_records
    from tpusr_torch.train import profiling
    x = torch.randn((1, 8, 8, 16), device=cuda)
    kk = torch.randn((3, 3, 16, 8), device=cuda)
    b = torch.zeros(8, device=cuda)
    rows = []
    for i in range(TRACE_SESSIONS):
        d = tmp_path / f"session{i}"
        with profiling.trace(str(d)):
            for _ in range(TRACE_LAUNCHES):
                k.conv3x3_bias_act(x, kk, b)
        events = json.loads((d / "trace.json").read_text())["traceEvents"]
        kept = trace_records(events, profiling.TRACE_LEAD_NAME)
        kept["k2"] = sum(1 for e in events if e.get("cat") == "kernel"
                         and "conv3x3" in e.get("name", ""))
        rows.append(kept)
    print(f"\n[trace] {torch.cuda.get_device_name(0)}: {TRACE_LAUNCHES} K2 "
          f"launches in each of {TRACE_SESSIONS} sessions; kernel records "
          f"lost per session: of the lead's launches "
          f"{[r['lead_lost'] for r in rows]} (of {rows[0]['lead']}), of the "
          f"block's {[r['block_lost'] for r in rows]}; K2 records "
          f"{[r['k2'] for r in rows]}")
    assert [r["k2"] for r in rows] == [TRACE_LAUNCHES] * TRACE_SESSIONS
    assert all(r["lead"] >= profiling.TRACE_LEAD_KERNELS for r in rows)
    assert 2 * max(r["lead_lost"] for r in rows) <= profiling.TRACE_LEAD_KERNELS
