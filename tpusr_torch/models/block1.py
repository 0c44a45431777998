"""Block 1 of the per-patch int8 VGG16, fused: K3 of the port (counterpart of
``tpusr/models/pallas_vgg.py``).

Per patch of the reference protocol (the ``patch`` x ``patch`` window at
``stride`` of the bottom/right reflect-padded image), K3 runs b1c1 (3 -> 64)
with its requant, b1c2 (64 -> 64) with its requant and the 2x2 max pool, and
returns the pooled int8 activations that block 2 takes. Each patch keeps its
own SAME zero padding. The result equals ``frames_to_pooled(block1_reference(
q, extract_patches_reference(...)))`` of the JAX package bit for bit.

- ``block1_int8`` launches the hand-written CUDA kernel of ``csrc/block1.cu``
  (both convs on the int8 tensor cores) for a CUDA tensor and calls
  ``block1_plain`` for a CPU tensor; there is no other dispatch.
  ``LAUNCHES`` counts its launches.
- The kernel takes any even ``patch`` and any ``stride`` at block-1 width
  64 (``takes``); ``quant.per_patch_int8_probs`` runs any other call through
  patch extraction and K1 alone.
- It reads both layers' weights packed K-major, as K1 does
  (``kernel_packed`` of the int8 trees, ``pack_int8_kernel``); a tree
  without them is packed per call.

The TPU kernel's layout helpers are not ported: ``pack_b1c1_img36``,
``pack_pair_taps_e2o``, ``build_img36_from_image``/``_from_poly``,
``_border_mask`` and the ``OUT_ROWS`` frame layout pack patches and weights
into 128-lane rows for the TPU's matrix unit. The CUDA kernel reads the
unpadded NHWC image and HWIO weights as they are and writes plain NHWC.
"""

from __future__ import annotations

import threading

import torch

from tpusr_torch.core import _build
from tpusr_torch.core.conv3x3 import (_check_cuda, conv3x3_int8_requant_plain,
                                      pack_int8_kernel)
from tpusr_torch.core.pad import pad_amounts, reflect_pad_hw
from tpusr_torch.core.patches import patch_grid_size, patchify

LAUNCHES = {"block1_int8": 0}
_launch_lock = threading.Lock()

_LAYERS = ("block1_conv1", "block1_conv2")


def reset_launch_counts() -> None:
    with _launch_lock:
        LAUNCHES["block1_int8"] = 0


def grid_counts(h: int, w: int, patch: int = 96, stride: int = 48):
    """Reference patch-grid geometry (pad = max((p-(d%s))%s, p-s), then
    range(0, d_pad-p+1, s)) -- loading_methods.py:6-26."""
    pad_h, pad_w = pad_amounts(h, w, patch, stride)
    return patch_grid_size(h + pad_h, w + pad_w, patch, stride)


def extract_patches_reference(images: torch.Tensor, patch: int = 96,
                              stride: int = 48) -> torch.Tensor:
    """(N, H, W, C) -> (N * n_h * n_w, patch, patch, C): the reference's
    patches of the bottom/right reflect-padded images, image-major, then row,
    then column."""
    h, w = images.shape[1:3]
    x = reflect_pad_hw(images, *pad_amounts(h, w, patch, stride))
    p = patchify(x, patch, stride)
    return p.reshape((-1,) + p.shape[2:])


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool of (N, H, W, C), any dtype."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def block1_plain(q: dict, images: torch.Tensor, patch: int = 96,
                 stride: int = 48) -> torch.Tensor:
    """The plain twin of K3: patch extraction, both convs on K1's plain twin
    (float64 ``F.conv2d``, exact) with quant.py's requant, and the pool."""
    x = extract_patches_reference(images, patch, stride)
    for name in _LAYERS:
        layer = q["layers"][name]
        x = conv3x3_int8_requant_plain(x, layer["kernel_q"], layer["rescale"],
                                       layer["bias_over_out"])
    return max_pool2x2(x)


def takes(q: dict, images: torch.Tensor, patch: int) -> bool:
    """Whether ``block1_int8`` takes a call at this ``patch`` on ``images``'
    device: an even patch, and on a card block-1 width 64 (the plain twin
    takes any width)."""
    width = q["layers"][_LAYERS[0]]["kernel_q"].shape[-1]
    return (patch >= 2 and patch % 2 == 0
            and (images.device.type != "cuda" or width == 64))


def _packed(layer: dict, cin: int, device) -> torch.Tensor:
    """The layer's K-major weights for the kernel: the tree's
    ``kernel_packed``, else packed here."""
    packed = layer.get("kernel_packed")
    if packed is None:
        return pack_int8_kernel(layer["kernel_q"])
    want = (64, 128 if cin == 3 else 640)
    if (tuple(packed.shape) != want or packed.dtype != torch.int8
            or packed.device != device):
        raise ValueError(f"block1_int8: kernel_packed must be int8 {want} on "
                         f"{device} (pack_int8_kernel), got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    return packed


def _check_args(q, images, patch, stride):
    name = "block1_int8"
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"{name}: images must be (N, H, W, 3), got "
                         f"{tuple(images.shape)}")
    if images.dtype != torch.int8:
        raise TypeError(f"{name}: images must be int8, got {images.dtype}")
    if patch < 2 or patch % 2 or stride < 1:
        raise ValueError(f"{name}: patch must be even and >= 2 and stride >= 1, "
                         f"got patch={patch} stride={stride}")
    operands = [images]
    width = q["layers"][_LAYERS[0]]["kernel_q"].shape[-1]
    for lname, cin in zip(_LAYERS, (3, width)):
        layer = q["layers"][lname]
        k = layer["kernel_q"]
        if tuple(k.shape) != (3, 3, cin, width) or k.dtype != torch.int8:
            raise ValueError(f"{name}: {lname} kernel must be int8 "
                             f"(3, 3, {cin}, {width}), got {k.dtype} "
                             f"{tuple(k.shape)}")
        for key in ("rescale", "bias_over_out"):
            v = layer[key]
            if tuple(v.shape) != (width,) or v.dtype != torch.float32:
                raise ValueError(f"{name}: {lname} {key} must be float32 "
                                 f"({width},), got {v.dtype} {tuple(v.shape)}")
        operands += [k, layer["rescale"], layer["bias_over_out"]]
    if images.device.type == "cuda" and width != 64:
        raise ValueError(f"{name}: the kernel is built for VGG16's block-1 "
                         f"width 64, got {width}")
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must be on one device, got "
                         f"{sorted(map(str, devices))}")
    return operands


def block1_int8(q: dict, images: torch.Tensor, patch: int = 96,
                stride: int = 48) -> torch.Tensor:
    """Fused patch extraction + b1c1 + b1c2 + 2x2 max pool (K3).

    ``q``: the port's int8 VGG16 tree (``quantize_vgg16``); ``images``:
    (N, H, W, 3) int8 on the classifier's input grid (``quantize_input``).
    Returns (N * n_h * n_w, patch // 2, patch // 2, C) int8, C = 64 (the
    plain twin takes the narrower block-1 widths of the CPU tests too),
    patches image-major, then row, then column.
    """
    operands = _check_args(q, images, patch, stride)
    if images.device.type == "cpu":
        return block1_plain(q, images, patch, stride)
    if images.device.type != "cuda":
        raise ValueError(f"block1_int8: unsupported device {images.device}")
    # the image is read byte by byte (a sub-batch view of an odd-sized
    # batch need not be 16-byte aligned); the packed weights come by 16-byte
    # copies and the output is written 16 bytes at a time
    if not images.is_contiguous():
        raise ValueError("block1_int8: operands must be contiguous")
    # each layer's kernel_q -> its packed copy
    operands[1] = _packed(q["layers"][_LAYERS[0]], 3, images.device)
    operands[4] = _packed(q["layers"][_LAYERS[1]], 64, images.device)
    _check_cuda("block1_int8", *operands[1:])
    n, h, w, _ = images.shape
    n_h, n_w = grid_counts(h, w, patch, stride)
    out = torch.empty((n * n_h * n_w, patch // 2, patch // 2, 64),
                      dtype=torch.int8, device=images.device)
    if out.numel() == 0:
        return out
    lib = _build.load("block1")
    stream = torch.cuda.current_stream(images.device).cuda_stream
    # operands: images, then kernel_packed, rescale, bias_over_out of each conv
    _build.check("block1", lib.block1_int8_launch(
        *(t.data_ptr() for t in operands), out.data_ptr(), n, h, w, patch,
        stride, n_h, n_w, stream))
    with _launch_lock:
        LAUNCHES["block1_int8"] += 1
    return out
