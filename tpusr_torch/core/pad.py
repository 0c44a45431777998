"""Reflect padding for sliding-window patch coverage (port of
``tpusr/core/pad.py``).

``reflect_pad`` gathers with a precomputed reflect-101 index, which works for
every dtype (int8 included) on every device.
"""

from __future__ import annotations

import torch


def pad_amounts(h: int, w: int, patch: int, stride: int) -> tuple[int, int]:
    """Bottom/right padding so patches of ``patch`` at ``stride`` cover (h, w)
    (loading_methods.py:12-17)."""
    pad_h = (patch - (h % stride)) % stride if h % stride != 0 else 0
    pad_w = (patch - (w % stride)) % stride if w % stride != 0 else 0
    pad_h = max(pad_h, patch - stride)
    pad_w = max(pad_w, patch - stride)
    return pad_h, pad_w


def reflect_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Indices of ``range(n)`` extended by ``pad`` reflect-101 entries at the
    end (edge not repeated, as ``np.pad(mode='reflect')``)."""
    if pad > n - 1:
        raise ValueError(f"reflect pad {pad} needs a dimension > {pad}, got {n}")
    i = torch.arange(n + pad, device=device)
    return torch.where(i < n, i, 2 * (n - 1) - i)


def reflect_pad_hw(image: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-pad the bottom/right of (..., H, W, C) by (pad_h, pad_w)."""
    h, w = image.shape[-3], image.shape[-2]
    x = image.index_select(-3, reflect_index(h, pad_h, image.device))
    return x.index_select(-2, reflect_index(w, pad_w, image.device))


def reflect_pad(image: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """Reflect-pad the bottom/right of (..., H, W, C) so the window fully
    covers it."""
    if image.dim() < 3:
        raise ValueError("reflect_pad expects (..., H, W, C)")
    pad_h, pad_w = pad_amounts(image.shape[-3], image.shape[-2], patch, stride)
    return reflect_pad_hw(image, pad_h, pad_w)
