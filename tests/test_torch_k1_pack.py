"""K1's and the int8 dequant conv's K-major weight packing
(tpusr_torch/core/conv3x3.py::pack_int8_kernel) on the CPU.

The CUDA kernels read their weights as (Cout_p, K_p) int8 rows, packed once
where the int8 trees are made (``kernel_packed``). These tests hold the
packing to its definition at the VGG16 and EDSR widths, the wrappers' CPU
path to the same bytes with packed and with HWIO weights and to the Pallas
kernel in interpret mode, the trees to their packed copies, and the build
to the headers a source includes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_conv3x3 import _int8_inputs
from test_torch_fixtures import to_numpy, vgg16_tree
from tpusr.core.pallas_conv import conv3x3_int8_requant as pallas_requant
from tpusr.models import quant as jq
from tpusr.models.vgg import _VGG16_CFG
from tpusr_torch.bridge import qtree_from_flax, vgg16_from_flax
from tpusr_torch.core import _build
from tpusr_torch.core import conv3x3 as k
from tpusr_torch.models import quant as tq


def _vgg16_layers(widths=(64, 128, 256, 512, 512)):
    """(Cin, Cout) of the 13 VGG16 convs at the published widths."""
    out, cin = [], 3
    for (_block, n_convs, _f), wd in zip(_VGG16_CFG, widths):
        for _ in range(n_convs):
            out.append((cin, wd))
            cin = wd
    return out


VGG16_LAYERS = _vgg16_layers()
# the 13 VGG16 convs, the int8 EDSR's head and body, and off-tile widths
PACK_CASES = VGG16_LAYERS + [(3, 64), (64, 64), (3, 3), (16, 8), (200, 130),
                             (4, 12)]


@pytest.mark.parametrize("cin,cout", PACK_CASES)
def test_packing_is_k_major_hwio_with_zero_padding(cin, cout):
    rng = np.random.default_rng(cin * 1000 + cout)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout))
                          .astype(np.int8))
    packed = k.pack_int8_kernel(wq)
    cout_p = -(-cout // 64) * 64
    k_p = -(-(9 * cin) // 128) * 128
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == (cout_p, k_p)
    want = torch.zeros((cout_p, k_p), dtype=torch.int8)
    want[:cout, :9 * cin] = wq.permute(3, 0, 1, 2).reshape(cout, 9 * cin)
    assert torch.equal(packed, want)
    # row co, column (ky*3 + kx)*Cin + ci is w_q[ky, kx, ci, co]
    ky, kx, ci, co = 2, 1, cin - 1, cout - 1
    assert packed[co, (ky * 3 + kx) * cin + ci] == wq[ky, kx, ci, co]
    assert torch.equal(k.unpack_int8_kernel(packed, cin, cout), wq)


# (N, H, W, Cin, Cout): the first VGG layer, a 64 -> 128 layer, a 6x6 batch
# (tiles of 128 pixels cross images on the card), off-tile widths
CPU_SHAPES = [(2, 9, 7, 3, 64), (2, 12, 12, 64, 128), (5, 6, 6, 64, 64),
              (3, 5, 6, 16, 8), (1, 4, 5, 200, 130)]


@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_wrappers_give_the_same_bytes_packed_and_hwio(shape):
    x, wq, rs, b = (torch.from_numpy(a)
                    for a in _int8_inputs(shape, seed=sum(shape)))
    packed = k.pack_int8_kernel(wq)
    k.reset_launch_counts()
    y_hwio = k.conv3x3_int8_requant(x, wq, rs, b)
    y_packed = k.conv3x3_int8_requant(x, wq, rs, b, packed)
    assert torch.equal(y_packed, y_hwio)
    d_hwio = k.conv3x3_int8_dequant(x, wq, rs, b)
    d_packed = k.conv3x3_int8_dequant(x, wq, rs, b, packed)
    assert d_packed.dtype == torch.bfloat16
    assert torch.equal(d_packed.view(torch.int16), d_hwio.view(torch.int16))
    # the CPU path computes on the packed copy: a corrupt one shows
    bad = packed.clone()
    bad[0, 0] = bad[0, 0] + 1 if bad[0, 0] < 127 else -127
    assert not torch.equal(k.conv3x3_int8_dequant(x, wq, rs, b, bad).view(
        torch.int16), d_hwio.view(torch.int16))
    # and the packed call still equals the Pallas kernel in interpret mode
    pallas = np.asarray(pallas_requant(jnp.asarray(x.numpy()),
                                       jnp.asarray(wq.numpy()),
                                       jnp.asarray(rs.numpy()),
                                       jnp.asarray(b.numpy()), interpret=True))
    np.testing.assert_array_equal(y_packed.numpy(), pallas)
    assert sum(k.LAUNCHES.values()) == 0       # CPU: the plain twins


def test_wrappers_refuse_packed_weights_of_another_shape():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    wq = torch.zeros((3, 3, 16, 8), dtype=torch.int8)
    v = torch.zeros(8)
    packed = k.pack_int8_kernel(wq)
    for bad in (packed[:, :128].contiguous(), packed[:32], packed.float(),
                k.pack_int8_kernel(torch.zeros((3, 3, 16, 72),
                                               dtype=torch.int8))):
        with pytest.raises(ValueError, match="packed"):
            k.conv3x3_int8_requant(x, wq, v, v, bad)
        with pytest.raises(ValueError, match="packed"):
            k.conv3x3_int8_dequant(x, wq, v, v, bad)


def test_int8_trees_carry_the_packed_kernels():
    rng = np.random.default_rng(2)
    params = vgg16_tree(rng)
    calib = rng.random((4, 32, 32, 3), dtype=np.float32)
    scales = jq.calibrate_vgg16(params, calib)
    trees = (tq.quantize_vgg16(vgg16_from_flax(params, device="cpu"), scales),
             qtree_from_flax(to_numpy(jq.quantize_vgg16(params, scales)),
                             device="cpu"))
    for q in trees:
        assert len(q["layers"]) == 13
        for name, layer in q["layers"].items():
            assert torch.equal(layer["kernel_packed"],
                               k.pack_int8_kernel(layer["kernel_q"])), name


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    (tmp_path / "s.cu").write_text('#include <stdint.h>\n#include "b.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("s")] == ["s.cu", "b.cuh", "a.cuh"]
    before = _build._lib_path("s")
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    assert _build._lib_path("s") != before
    # the port's own sources: the int8 and float convs share cp_async.cuh
    monkeypatch.undo()
    assert "cp_async.cuh" in [p.name for p in _build.sources("conv3x3")]
