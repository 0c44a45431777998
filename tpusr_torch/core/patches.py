"""Sliding-window patch extraction and overlap-add reconstruction (port of
``tpusr/core/patches.py``).

The JAX package has two overlap-add paths, dense shifted adds when the
stride divides the patch and a scan of scatter-adds otherwise. Here one
``F.fold`` (col2im) covers both: every output pixel gathers the patches that
cover it, in a fixed order, with no atomics.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def patch_grid_size(h: int, w: int, patch: int, stride: int) -> tuple[int, int]:
    """Number of patch rows/cols for a sliding window (VALID coverage)."""
    return (h - patch) // stride + 1, (w - patch) // stride + 1


def patchify(image: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., nH*nW, patch, patch, C) sliding-window patches
    in row-major patch order (the reference's double loop,
    ``SRCNN_model.py:156-160``). Any dtype, any device."""
    h, w, c = image.shape[-3:]
    nh, nw = patch_grid_size(h, w, patch, stride)
    lead = image.shape[:-3]
    # unfold -> (..., nH, W, C, p) -> (..., nH, nW, C, p, p)
    x = image.unfold(-3, patch, stride).unfold(-3, patch, stride)
    x = x.permute(*range(len(lead)), -5, -4, -2, -1, -3)
    return x.reshape(*lead, nh * nw, patch, patch, c)


@functools.lru_cache(maxsize=256)
def _overlap_weight_np(nh: int, nw: int, patch: int, stride: int) -> np.ndarray:
    """Per-pixel patch-coverage count over the padded canvas (host, cached)."""
    out_h = (nh - 1) * stride + patch
    out_w = (nw - 1) * stride + patch
    wt = np.zeros((out_h, out_w), dtype=np.float32)
    for i in range(nh):
        for j in range(nw):
            wt[i * stride: i * stride + patch, j * stride: j * stride + patch] += 1.0
    return wt


def overlap_weight(nh: int, nw: int, patch: int, stride: int) -> np.ndarray:
    return _overlap_weight_np(nh, nw, patch, stride)


def overlap_add(patches: torch.Tensor, grid_hw: tuple[int, int], stride: int,
                crop_hw: tuple[int, int] | None = None,
                average: bool = True) -> torch.Tensor:
    """Reconstruct (H, W, C) from (nH*nW, p, p, C) patches by overlap-averaging.

    Mirrors ``reconstruct_from_patches`` (SRCNN_model.py:164-188): sum patch
    contributions, divide by the per-pixel coverage count (0 where
    uncovered), crop to ``crop_hw``. Clipping is left to the caller (models
    clip to their own output ranges).
    """
    nh, nw = grid_hw
    n, p, _, c = patches.shape
    if n != nh * nw:
        raise ValueError(f"patch count {n} != grid {nh}x{nw}")
    out_h = (nh - 1) * stride + p
    out_w = (nw - 1) * stride + p
    # fold takes (N, C*p*p, L) with C outermost, L the row-major patch index
    cols = patches.permute(3, 1, 2, 0).reshape(1, c * p * p, n)
    recon = F.fold(cols, (out_h, out_w), p, stride=stride)[0].permute(1, 2, 0)
    if average:
        wt = torch.from_numpy(_overlap_weight_np(nh, nw, p, stride)).to(
            recon.device, recon.dtype)[..., None]
        recon = torch.where(wt > 0, recon / wt, torch.zeros((), dtype=recon.dtype,
                                                            device=recon.device))
    if crop_hw is not None:
        recon = recon[: crop_hw[0], : crop_hw[1], :]
    return recon
