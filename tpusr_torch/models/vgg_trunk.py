"""Shared-trunk patch-vote classification (port of
``tpusr/models/vgg_trunk.py``): one full-image VGG16 trunk, int8 or f32,
instead of one forward per overlapping patch.

With stride 48 and patch 96 the patch offsets align with pool grids 1-4;
pool5 alternates parity per patch, handled by a stride-1 max pool, a
dilation-2 mean window and a stride-3 slice:

    pool5_s1[r] = max(b5c3[r], b5c3[r+1])
    gap[r]      = mean_{t,u in 0..m-1} pool5_s1[r+2t]
    patch k GAP = gap[3k]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpusr_torch.core.pad import pad_amounts, reflect_pad
from tpusr_torch.core.patches import patch_grid_size
from tpusr_torch.models.quant import f32, head_probs, int8_backbone, quantize_input


def trunk_geometry(h: int, w: int, patch: int, stride: int):
    """(pad_h, pad_w, n_h, n_w) for the reference patch grid, with the
    alignment preconditions the shared trunk needs."""
    if stride % 16 != 0 or patch % 32 != 0:
        raise ValueError(
            f"shared trunk needs stride % 16 == 0 and patch % 32 == 0 "
            f"(pool grids 1-4 must align); got patch={patch} stride={stride}")
    pad_h, pad_w = pad_amounts(h, w, patch, stride)
    if (h + pad_h) % 16 or (w + pad_w) % 16:
        raise ValueError("padded image must be divisible by 16")
    n_h, n_w = patch_grid_size(h + pad_h, w + pad_w, patch, stride)
    return pad_h, pad_w, n_h, n_w


def _cells_to_patch_feats(feats_s1: torch.Tensor, patch: int, stride: int,
                          n_h: int, n_w: int) -> torch.Tensor:
    """(N, C5-1, C5-1, C) f32 stride-1-pooled cells -> (N, n_h, n_w, C)
    per-patch GAP features (mean over the patch's m x m pool5 cells)."""
    m = patch // 32          # pool5 cells per patch (3 for patch 96)
    ss = stride // 16        # patch offset in /16 cells (3 for stride 48)
    hh = feats_s1.shape[1] - 2 * (m - 1)
    ww = feats_s1.shape[2] - 2 * (m - 1)
    gap = sum(feats_s1[:, 2 * t: 2 * t + hh, 2 * u: 2 * u + ww]
              for t in range(m) for u in range(m))
    gap = gap / f32(float(m * m), gap.device)
    return gap[:, : (n_h - 1) * ss + 1: ss, : (n_w - 1) * ss + 1: ss, :]


def _head_probs(feats: torch.Tensor, head: dict) -> torch.Tensor:
    """(N, n_h, n_w, C) -> (N, n_h*n_w, classes) softmax probs."""
    probs = head_probs(feats, head)
    n, nh, nw, c = probs.shape
    return probs.reshape(n, nh * nw, c)


def shared_trunk_probs_int8(q: dict, images: torch.Tensor, patch: int = 96,
                            stride: int = 48) -> torch.Tensor:
    """int8 shared-trunk patch probabilities.

    ``images``: (N, H, W, 3) [0, 1] f32, or int8 from ``quantize_input``.
    Returns (N, n_patches, classes) probs in row-major patch order.
    """
    if images.dtype != torch.int8:
        images = quantize_input(q, images)
    n, h, w, _ = images.shape
    _, _, n_h, n_w = trunk_geometry(h, w, patch, stride)
    x = reflect_pad(images, patch, stride)
    # block 5 pools at stride 1 below, for per-patch pool parity
    x = int8_backbone(q, x, pool5=False)
    pooled_s1 = torch.maximum(torch.maximum(x[:, :-1, :-1], x[:, 1:, :-1]),
                              torch.maximum(x[:, :-1, 1:], x[:, 1:, 1:]))
    feats_s1 = pooled_s1.float() * q["final_scale"]
    feats = _cells_to_patch_feats(feats_s1, patch, stride, n_h, n_w)
    return _head_probs(feats, q["head"])


def shared_trunk_probs_f32(model, images: torch.Tensor, patch: int = 96,
                           stride: int = 48) -> torch.Tensor:
    """Float shared-trunk patch probabilities from a ``VGG16Classifier``
    (the f32 variant of ``shared_trunk_probs_int8``). The convs are the
    model's own ``nn.Conv2d`` (TF32 off), as ``per_patch_f32`` runs them;
    the JAX package runs these as XLA convs, not Pallas kernels.

    ``images``: (N, H, W, 3) [0, 1], cast to the model's dtype. Returns
    (N, n_patches, classes) probs in row-major patch order.
    """
    n, h, w, _ = images.shape
    _, _, n_h, n_w = trunk_geometry(h, w, patch, stride)
    x = reflect_pad(images.to(model.fc1.weight.dtype), patch, stride)
    x = x.permute(0, 3, 1, 2)
    for b, n_convs, _wd in model.blocks:
        for c in range(1, n_convs + 1):
            x = F.relu(model.vgg16[f"block{b}_conv{c}"](x))
        if b < 5:
            x = F.max_pool2d(x, 2, 2)
    pooled_s1 = F.max_pool2d(x, 2, 1).permute(0, 2, 3, 1)
    feats = _cells_to_patch_feats(pooled_s1, patch, stride, n_h, n_w)
    h1 = F.relu(model.fc1(feats))
    probs = torch.softmax(model.predictions(h1), dim=-1)
    return probs.reshape(n, n_h * n_w, probs.shape[-1])
