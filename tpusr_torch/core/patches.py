"""Sliding-window patch extraction (port of ``tpusr/core/patches.py``)."""

from __future__ import annotations

import torch


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
