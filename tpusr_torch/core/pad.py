"""Reflect padding for sliding-window patch coverage (port of
``tpusr/core/pad.py``), and the two-sided ``np.pad`` modes of the classic
algorithms.

Padding gathers with a precomputed index, which works for every dtype (int8
included) on every device. ``F.pad`` has no ``symmetric`` mode and refuses a
reflect pad >= the dimension, where ``np.pad`` reflects repeatedly.
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


def pad_index(n: int, before: int, after: int, mode: str = "reflect",
              device=None) -> torch.Tensor:
    """Indices into ``range(n)`` of ``np.pad(np.arange(n), (before, after),
    mode)`` for ``mode`` 'reflect' (reflect-101: edge not repeated, cv2's
    BORDER_REFLECT_101) or 'symmetric' (edge repeated, pywt's 'symmetric'),
    for any pad. Both are periodic extensions, which is what ``np.pad``'s
    repeated reflection gives when a pad is >= n."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = i.remainder(period)
        return torch.where(i < n, i, period - i)
    if mode == "symmetric":
        period = 2 * n
        i = i.remainder(period)
        return torch.where(i < n, i, period - 1 - i)
    raise ValueError(f"unknown pad mode {mode!r}")


def pad_2d(x: torch.Tensor, pad: int, mode: str = "reflect",
           dims: tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """``np.pad`` by ``pad`` on both sides of each axis in ``dims``."""
    for d in dims:
        x = x.index_select(d, pad_index(x.shape[d], pad, pad, mode, x.device))
    return x


def reflect_pad_hw(image: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-pad the bottom/right of (..., H, W, C) by (pad_h, pad_w)."""
    h, w = image.shape[-3], image.shape[-2]
    x = image.index_select(-3, pad_index(h, 0, pad_h, device=image.device))
    return x.index_select(-2, pad_index(w, 0, pad_w, device=image.device))


def reflect_pad(image: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """Reflect-pad the bottom/right of (..., H, W, C) so the window fully
    covers it."""
    if image.dim() < 3:
        raise ValueError("reflect_pad expects (..., H, W, C)")
    pad_h, pad_w = pad_amounts(image.shape[-3], image.shape[-2], patch, stride)
    return reflect_pad_hw(image, pad_h, pad_w)
