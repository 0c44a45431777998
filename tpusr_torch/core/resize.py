"""OpenCV-parity separable resampling as two matrix products (port of
``tpusr/core/resize.py``).

``out = Wv @ img @ Wh.T``, where the dense (out, in) weight matrices carry
OpenCV's filter taps: src = (dst + 0.5) * (in/out) - 0.5, taps clamped to the
image (border replicate), cubic a = -0.75, Lanczos4 = 8 taps normalized,
INTER_AREA as fractional box overlaps when shrinking and cv2's linear-like
mapping when enlarging. The weights are built in float64 with numpy, cast to
float32 and cached; the products are ``torch.matmul`` in float32 (TF32 off),
as the JAX package left them to XLA at HIGHEST precision.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpusr_torch.device import fp32_math

__all__ = ["resize", "resize_weights", "METHODS"]

METHODS = ("bilinear", "bicubic", "area", "lanczos4")


def _accumulate(out_size: int, in_size: int, dst_idx, tap_idx, tap_w) -> np.ndarray:
    """Scatter taps (clamped to the image) into a dense (out, in) weight matrix."""
    W = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(W, (dst_idx, np.clip(tap_idx, 0, in_size - 1)), tap_w)
    return W


def _src_coords(out_size: int, in_size: int):
    scale = in_size / out_size
    dst = np.arange(out_size)
    src = (dst + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    t = src - x0
    return dst, x0, t


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    dst, x0, t = _src_coords(out_size, in_size)
    W = _accumulate(out_size, in_size, dst, x0, 1.0 - t)
    W += _accumulate(out_size, in_size, dst, x0 + 1, t)
    return W


def _cubic_kernel(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    d = np.abs(d)
    inner = ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0
    outer = (((d - 5.0) * d + 8.0) * d - 4.0) * a
    return np.where(d <= 1.0, inner, np.where(d < 2.0, outer, 0.0))


def _bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    dst, x0, t = _src_coords(out_size, in_size)
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for o in (-1, 0, 1, 2):
        W += _accumulate(out_size, in_size, dst, x0 + o, _cubic_kernel(t - o))
    return W


def _lanczos4_kernel(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, dtype=np.float64)
    eps = np.abs(d) < 1e-12
    x = np.where(eps, 1.0, d)
    k = (np.sin(np.pi * x) * np.sin(np.pi * x / 4.0)) / (np.pi * np.pi * x * x / 4.0)
    return np.where(eps, 1.0, np.where(np.abs(d) < 4.0, k, 0.0))


def _lanczos4_weights(in_size: int, out_size: int) -> np.ndarray:
    dst, x0, t = _src_coords(out_size, in_size)
    offs = np.arange(-3, 5)
    raw = np.stack([_lanczos4_kernel(t - o) for o in offs], axis=0)  # (8, out)
    raw /= raw.sum(axis=0, keepdims=True)  # cv2 normalizes the 8 taps
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for k, o in enumerate(offs):
        W += _accumulate(out_size, in_size, dst, x0 + o, raw[k])
    return W


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    W = np.zeros((out_size, in_size), dtype=np.float64)
    if scale >= 1.0:
        # Shrinking: fractional box-overlap weights (cv2 resizeArea).
        for o in range(out_size):
            start, end = o * scale, (o + 1) * scale
            i0, i1 = int(np.floor(start)), int(np.ceil(end))
            for i in range(i0, min(i1, in_size)):
                overlap = min(i + 1.0, end) - max(float(i), start)
                if overlap > 0:
                    W[o, i] = overlap / scale
        # Guard for numerical edge cases at the right border.
        rs = W.sum(axis=1, keepdims=True)
        W = W / np.where(rs == 0, 1.0, rs)
    else:
        # Enlarging: cv2 maps INTER_AREA to a linear-like scheme:
        #   sx = floor(dx*scale); fx = (dx+1) - (sx+1)/scale^{-1}; fx<=0 -> 0
        inv_scale = out_size / in_size
        dst = np.arange(out_size)
        sx = np.floor(dst * scale).astype(np.int64)
        fx = (dst + 1) - (sx + 1) * inv_scale
        fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
        W = _accumulate(out_size, in_size, dst, sx, 1.0 - fx)
        W += _accumulate(out_size, in_size, dst, sx + 1, fx)
    return W


_BUILDERS = {
    "bilinear": _bilinear_weights,
    "bicubic": _bicubic_weights,
    "area": _area_weights,
    "lanczos4": _lanczos4_weights,
}


@functools.lru_cache(maxsize=512)
def _resize_weights_np(in_size: int, out_size: int, method: str) -> np.ndarray:
    if method not in _BUILDERS:
        raise ValueError(f"unknown resize method {method!r}; expected one of {METHODS}")
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    return _BUILDERS[method](in_size, out_size).astype(np.float32)


def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Dense (out_size, in_size) 1-D resampling matrix with cv2-parity taps."""
    return _resize_weights_np(int(in_size), int(out_size), method)


@functools.lru_cache(maxsize=512)
def _weights_on(in_size: int, out_size: int, method: str,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size, method)).to(device)


def resize(x: torch.Tensor, out_hw: tuple[int, int],
           method: str = "bicubic") -> torch.Tensor:
    """Resize (..., H, W, C) or (H, W) images with OpenCV-parity filters:
    a vertical then a horizontal float32 matrix product."""
    fp32_math()
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    two_d = x.dim() == 2
    if two_d:
        x = x[..., None]
    *lead, in_h, in_w, c = x.shape
    xf = x if x.dtype == torch.float32 else x.float()
    wv = _weights_on(in_h, out_h, method, x.device)
    wh = _weights_on(in_w, out_w, method, x.device)
    y = torch.matmul(wv, xf.reshape(*lead, in_h, in_w * c))
    y = torch.matmul(wh, y.reshape(*lead, out_h, in_w, c))
    return y[..., 0] if two_d else y
